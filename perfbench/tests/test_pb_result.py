"""The result line's shape: the contract's keys, the cell's metrics by
name and unit, the compared numbers last."""
import json
import time
from pathlib import Path

import pytest

import run
import tiny
from pbcore import runner

ROOT = Path(__file__).resolve().parents[1]
PEAKS = json.loads((ROOT / "peaks.json").read_text())


@pytest.fixture(scope="module")
def record():
    rec = runner.execute(tiny.cell("gambia.bell_tiles"), 17, 0.0, False, "cpu",
                         time.perf_counter(), PEAKS)
    rec["peak_bytes"] = 123
    rec["trace"] = {"busy_s": 0.5, "window_s": 1.0, "gaps": [["train_epoch", 0.5]],
                    "by_op": [["void f_spmm_wmma_kernel<1>(float*)", 0.25],
                              ["ampere_sgemm_128x64_nn", 0.25]]}
    return rec


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(record, traced):
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    limits = {"loss_gap": 1, "grad_gap": 1, "change_gap": 1, "val_gap": 1}
    result, _ = run.result_line(bench, "gambia.bell_tiles", record, limits, "card", 1, traced)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "check" and result["correct"] is True
    assert result["attempted"] == record["epochs"][0]["train_steps"] and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        want = {m["name"]: m["unit"] for m in bench["per_layer"]
                if "gambia.bell_tiles" in m["workloads"]}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        want = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    got = {k: v["unit"] for k, v in result["metrics"].items()}
    assert set(got) <= set(want) and all(want[k] == u for k, u in got.items())
    if not traced:
        assert set(got) == set(want)
    json.dumps(result)   # a plain JSON object
    result, _ = run.result_line(bench, "gambia.bell_tiles", record,
                                dict(limits, val_gap=0.0), "card", 1, traced)
    assert result["correct"] is False
