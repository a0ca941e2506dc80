"""The per-layer readers and the trace's reduction on a synthetic trace."""
import json
from pathlib import Path

import pytest
import torch

from pbcore import trace
from pbcore.layers import bound_seconds, module

ROOT = Path(__file__).resolve().parents[1]
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._row = (name, device, start, end, annotation)

    def name(self):
        return self._row[0]

    def device_type(self):
        return self._row[1]

    def start_ns(self):
        return self._row[2]

    def duration_ns(self):
        return self._row[3] - self._row[2]

    def is_user_annotation(self):
        return self._row[4]


class _Prof:
    def __init__(self, rows):
        class K:
            def events(_):
                return [_Event(*r) for r in rows]

        class P:
            kineto_results = K()

        self.profiler = P()


ROWS = [
    ("perfbench.window", CPU, 0, 1_000_000),
    ("perfbench.train_epoch", CPU, 0, 600_000),
    ("perfbench.evaluate", CPU, 600_000, 1_000_000),
    ("cudaGraphLaunch", CPU, 10_000, 20_000),
    ("cudaStreamSynchronize", CPU, 700_000, 900_000),
    # two overlapping kernels on two streams, one annotation span
    ("void f_spmm_wmma_kernel<2, 64, 1, float>(float const*)", CUDA, 100_000, 300_000),
    ("ampere_sgemm_128x64_nn", CUDA, 200_000, 400_000),
    ("void k2_wmma_kernel<float, 1>(float const*)", CUDA, 500_000, 600_000),
    ("perfbench.train_epoch", CUDA, 0, 600_000, True),
]


def test_union_merges_overlapping_intervals():
    rows = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 35, 38), ("e", 50, 60)]
    assert trace.union(rows, 0, 55) == [[0, 20], [30, 40], [50, 55]]


def test_reduce_counts_overlap_once():
    t = trace.reduce(_Prof(ROWS))
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(4e-4)         # [100, 400) and [500, 600) µs
    assert dict(t["by_op"])["ampere_sgemm_128x64_nn"] == pytest.approx(2e-4)
    gaps = dict(t["gaps"])
    assert sum(gaps.values()) == pytest.approx(6e-4)
    assert gaps["evaluate:cudaStreamSynchronize"] == pytest.approx(4e-4)
    assert gaps["train_epoch"] == pytest.approx(2e-4)


def test_kernel_name():
    assert trace.kernel_name("void f_spmm_wmma_kernel<2, 64>(float*)") == "f_spmm_wmma_kernel"
    assert trace.kernel_name("void at::native::elementwise_kernel<128>(int)") == \
        "elementwise_kernel"
    assert trace.kernel_name("ampere_sgemm_128x64_nn") is None


def _run():
    t = trace.reduce(_Prof(ROWS))
    block = {"B": 4, "N": 2139, "F": 4, "C": 4, "T": 144, "Co": 32, "Ct": 32, "K": 2, "H": 2,
             "dk": 32, "dv": 32, "d": 64, "P": 12, "nb_block": 2, "needs_dx": False,
             "A": 49, "BS": 128}
    return {"trace": t, "blocks": [block, dict(block, F=32, C=32, needs_dx=True)],
            "train_steps": 1, "val_batches": 0, "dtype_bytes": 4, "window_s": 2.0,
            "peaks": json.loads((ROOT / "peaks.json").read_text()),
            "epochs": [{"train_s": 1.5, "val_s": 0.5, "train_steps": 1}]}


def test_readers():
    run = _run()
    read = lambda name: module("metrics", name).read(run)
    assert read("device.idle_share") == pytest.approx(0.6)
    assert read("trainer.val_share") == pytest.approx(0.25)
    assert read("step.train_ms") == pytest.approx(1500.0)
    assert read("model.torch_ops_ms") == pytest.approx(0.2)   # the sgemm only, per step
    least = sum(bound_seconds(run, f)[0] for f in ("bell_fused", "bell_k1", "bell_k2"))
    share, note = read("bell_roofline")
    assert share == pytest.approx(100 * least / 3e-4) and note.startswith("bound by")
    # no cheb_sat kernel in the trace: nothing to read
    assert read("cheb_sat_roofline") is None
    assert 0 < read("step_mfu") < 100


def test_every_benchmark_metric_has_a_reader():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(module("metrics", m["name"]).read)


def test_a_shared_kernel_counts_in_full_and_alone_reads_nothing():
    """colsum_kernel, which several families launch, counts in each of
    their rooflines' device time; a trace with only it and no kernel of
    the family's own gives that family nothing to read."""
    from pbcore.layers import family, kernels, roofline

    for name in ("bell", "gtu_fused", "tat_fused", "spatial_fused"):
        assert "colsum_kernel" in kernels(name) and "colsum_kernel" not in family(name)["kernels"]
    run = _run()
    colsum = ("void dense::(anonymous namespace)::colsum_kernel(float const*, float*, int, int, "
              "int)", 1e-4)
    run["trace"] = dict(run["trace"], by_op=run["trace"]["by_op"] + [colsum])
    least = sum(bound_seconds(run, f)[0] for f in ("bell_fused", "bell_k1", "bell_k2"))
    assert roofline(run, "bell")[0] == pytest.approx(100 * least / 4e-4)
    assert module("metrics", "model.torch_ops_ms").read(run) == pytest.approx(0.2)
    assert roofline(run, "tat_fused") is None
    only = dict(run, trace=dict(run["trace"], by_op=[colsum]))
    assert roofline(only, "bell") is None
