"""Profiling and TensorBoard of the port, on the CPU: the four cases of
``tests/test_profiling.py`` (trace artifacts, StepTimer, throughput, a
trainer epoch under a trace) plus the TensorBoard logger, ``throughput``
equal to JAX's for the same arguments, and the train CLI's ``--profile``
and ``--tensorboard`` end to end."""
import json
import os

import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.training.profiling import throughput as jax_throughput
from dstagnn_drought_tpu_torch.training.profiling import (
    StepTimer,
    annotate,
    throughput,
    trace,
)

torch.set_num_threads(1)


def test_trace_writes_artifacts(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        with annotate("matmul"):
            x = torch.ones((8, 8)) @ torch.ones((8, 8))
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(logdir) for f in fs]
    assert files, "profiler trace produced no files"
    text = open(os.path.join(logdir, "trace.json")).read()
    assert "matmul" in text and "aten::mm" in text
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert float(x[0, 0]) == 8.0


def test_step_timer_mean():
    t = StepTimer(drop_first=True)
    t.start()
    for _ in range(3):
        t.fence(torch.zeros(()), steps=2)
    assert len(t.samples) == 2
    assert t.mean_step_seconds() > 0
    assert StepTimer().mean_step_seconds() != StepTimer().mean_step_seconds()  # nan


@pytest.mark.parametrize("kw", [
    dict(step_seconds=0.01, batch_size=64, nnz=290, K=3, T=12, n_chips=1),
    dict(step_seconds=0.0731, batch_size=4, nnz=8556, K=2, T=144, n_chips=4),
])
def test_throughput_counters(kw):
    out = throughput(**kw)
    assert out == jax_throughput(**kw)
    if kw["n_chips"] == 1:
        assert out["windows_per_s"] == pytest.approx(6400)
        assert out["edges_per_s_per_chip"] == pytest.approx(290 * 3 * 12 * 64 / 0.01)


def test_trainer_epoch_under_trace(tmp_path):
    """An epoch of train steps runs correctly inside a trace region (the
    --profile path)."""
    from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec, make_model
    from dstagnn_drought_tpu_torch.training.step import make_optimizer, train_step

    spec = ModelSpec(num_of_vertices=6, len_input=12, num_for_predict=4, num_of_d=1,
                     nb_block=2, in_channels=1, K=2, nb_chev_filter=4, nb_time_filter=4,
                     d_model=8, d_k=4, n_heads=2)
    rng = np.random.default_rng(0)
    A = np.eye(6, dtype=np.float32)
    A[0, 1] = A[1, 0] = 1
    model, consts = make_model(spec, A, A, seed=0, device="cpu")
    opt = make_optimizer(model.parameters(), 1e-3)
    x = torch.from_numpy(rng.normal(size=(8, 6, 1, 12)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(8, 6, 4)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    logdir = str(tmp_path / "prof")
    with trace(logdir):
        losses = [train_step(model, opt, x[i:i + 4], y[i:i + 4], consts, generator=gen)
                  for i in (0, 4)]
    assert all(np.isfinite(float(v)) for v in losses)
    assert os.path.isfile(os.path.join(logdir, "trace.json"))


def test_metric_logger_tensorboard(tmp_path):
    """TensorBoard scalars land in event files alongside the JSONL, keyed by
    epoch or by the event's count."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from dstagnn_drought_tpu_torch.training.logger import MetricLogger

    tb = str(tmp_path / "tb")
    lg = MetricLogger(str(tmp_path / "m.jsonl"), tensorboard_dir=tb)
    lg.log("epoch", epoch=0, train_loss=1.5, val_loss=2.0)
    lg.log("epoch", epoch=1, train_loss=1.0, val_loss=1.8)
    lg.log("test", loss=0.9, mae=1.1, checkpoint="x.pt")
    lg.log("test", loss=0.8, mae=1.0)
    lg.close()
    files = os.listdir(tb)
    assert any("tfevents" in f for f in files), files
    acc = EventAccumulator(tb)
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["epoch/train_loss", "epoch/val_loss",
                                            "test/loss", "test/mae"]
    assert [(s.step, s.value) for s in acc.Scalars("epoch/train_loss")] == [(0, 1.5), (1, 1.0)]
    assert [s.step for s in acc.Scalars("test/mae")] == [0, 1]
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 4


def test_metric_logger_without_tensorboardx(tmp_path, monkeypatch, capsys):
    """Without tensorboardX the logger says so and the JSONL still works."""
    import sys

    from dstagnn_drought_tpu_torch.training.logger import MetricLogger

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    lg = MetricLogger(str(tmp_path / "m.jsonl"), tensorboard_dir=str(tmp_path / "tb"))
    assert "tensorboard logging disabled" in capsys.readouterr().out
    lg.log("epoch", epoch=0, train_loss=1.0)
    lg.close()
    assert json.loads((tmp_path / "m.jsonl").read_text())["train_loss"] == 1.0
    assert not (tmp_path / "tb").exists()


def test_cli_profile_and_tensorboard(toy_project, tmp_path):
    """--profile traces the first epoch, logs ``profile`` and trains the rest;
    --tensorboard writes event files under <run_dir>/tb."""
    from dstagnn_drought_tpu.cli import prepare_data
    from dstagnn_drought_tpu_torch.cli import train

    conf = str(toy_project / "TOY.conf")
    prepare_data.main(["--config", conf])
    exp, prof = tmp_path / "exp", tmp_path / "prof"
    result = train.main(["--config", conf, "--experiments-root", str(exp), "--epochs", "2",
                         "--device", "cpu", "--profile", str(prof), "--tensorboard"])
    assert np.isfinite(result["test_loss"])
    assert "aten::" in (prof / "trace.json").read_text()
    run_dir = next((exp / "TOY").iterdir())
    events = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events][:2] == ["profile", "epoch"]
    assert events[0]["epoch"] == 0 and events[0]["logdir"] == str(prof)
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1]
    assert any("tfevents" in f for f in os.listdir(run_dir / "tb"))
