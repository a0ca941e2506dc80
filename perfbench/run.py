#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration and traffic are found
by name from ``BENCHMARK.json``; the inputs and the initial weights are
made from ``--seed``; the program (``dstagnn_drought_tpu_torch``'s
``Trainer``) is warmed up by the first three training steps and one
validation pass, which capture its CUDA graphs, and then measured for whole epochs until
``--seconds`` have passed. The plain reference then checks the first
training steps and the last validation predictions. The last line of
standard output is the result as one JSON object; the numbers compared and
their limits are also the last lines of standard error. Without a CUDA card
it exits with 2 and prints no result. It writes a temporary work directory
under ``$TMPDIR`` (removed at exit) and the program's kernel builds under
the checkout's ``build/kernels/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

# the JAX side of the repository, which no run may load (top-level names,
# compared whole: the program's own name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "dstagnn_drought_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def per_layer(bench: dict, workload: str) -> list:
    return [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]


def read_layers(bench: dict, workload: str, record: dict) -> tuple[dict, list]:
    """{name: {value, unit}} of the cell's per-layer metrics whose readers
    found something, and their notes."""
    from pbcore.layers import module

    out, notes = {}, []
    for m in per_layer(bench, workload):
        got = module("metrics", m["name"]).read(record)
        if isinstance(got, tuple):
            got, note = got
            notes.append(f"{m['name']}: {note}")
        if got is not None and math.isfinite(got):
            out[m["name"]] = {"value": got, "unit": m["unit"]}
    return out, notes


def result_line(bench: dict, workload: str, record: dict, limits: dict, kind: str, chips: int,
                traced: bool) -> tuple[dict, list]:
    """The result object (its keys in the contract's order, the compared
    numbers last) and the per-layer readers' notes."""
    from pbcore import check

    numbers = record["numbers"]
    losses = [x for e in record["epochs"] for x in e["losses"]]
    if traced:
        metrics, notes = read_layers(bench, workload, record)
    else:
        metrics, notes = {
            "train_windows_per_s": {"value": record["train_windows"] / record["window_s"],
                                    "unit": "windows/s"},
            "peak_mem_gib": {"value": record["peak_bytes"] / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": record["setup_s"], "unit": "s"}}, []
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": record["peak_bytes"]}
    result = {"correct": bool(limits) and check.verdict(numbers, limits),
              "attempted": len(losses), "failed": sum(1 for x in losses if not math.isfinite(x)),
              "metrics": metrics, "device": device}
    if traced:
        t = record["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in t["by_op"][:10]],
                               "idle_gaps": [[n[:160], s] for n, s in t["gaps"][:10]]}
    result["check"] = {k: {"value": numbers[k], "limit": limits.get(k)} for k in check.NAMES}
    return result, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pbcore import runner

    cell = runner.load_cell(args.workload)
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind}; nvidia-smi name, power limit: {power_limit()}", flush=True)
    bench, config = cell["bench"], cell["config"]
    runner.set_tf32(config)
    peaks = json.loads((HERE / "peaks.json").read_text())

    record = runner.execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                            peaks)
    print(f"window: {record['window_s']:.6f} s, {len(record['epochs'])} epochs; set-up s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in record["setup_parts"].items()), flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    result, notes = result_line(bench, args.workload, record, cell["limits"] or {}, kind, chips,
                                bool(args.trace))
    for note in notes:
        print(note, file=sys.stderr)
    numbers = record["numbers"]
    print("check where: " + json.dumps(numbers["where"]), file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
