"""A whole run on the CPU (the card's check skipped), with the program's
timed path broken underneath, comes out not correct against the cell's
limits: a step that leaves the state unchanged, half of each batch left
out with the mean taken over the rest, and an answer altered where the
eval step produces it. (One chip: no exchange between chips to leave out.)"""
import time

import pytest
import torch

import tiny
from pbcore import check, runner

PEAKS = {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
CELLS = ("gambia.bell_tiles", "pems08.fused", "gambia.dense", "pems08.dense")


def _correct(workload):
    cell = tiny.cell(workload)
    rec = runner.execute(cell, 2 ** 32 + 21, 0.0, False, "cpu", time.perf_counter(), PEAKS)
    return check.verdict(rec["numbers"], cell["limits"]), rec["numbers"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert _correct(workload)[0]


def _unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(mp):
    from dstagnn_drought_tpu_torch.training import step

    loss = step.smooth_l1_loss

    def half(pred, target, **kw):
        h = pred.shape[0] // 2
        w = kw.pop("sample_weights", None)
        kw.pop("weight_total", None)
        return loss(pred[:h], target[:h], sample_weights=None if w is None else w[:h], **kw)

    mp.setattr(step, "smooth_l1_loss", half)


def _altered_answer(mp):
    from dstagnn_drought_tpu_torch.training import loop

    evaluate = loop.eval_step

    def altered(*a, **kw):
        pred, losses = evaluate(*a, **kw)
        return pred.index_fill(0, torch.tensor([0], device=pred.device), 0.0), losses

    mp.setattr(loop, "eval_step", altered)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    ok, numbers = _correct(workload)
    assert not ok, numbers
