"""What the per-layer readers of ``perfbench/metrics/`` share: loading a
file of the benchmark by name, the device time of a kernel family, and a
family's share of its roofline."""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

from pbcore.trace import kernel_name

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def family(name: str) -> dict:
    """``perfbench/kernels/<name>.json``: a kernel family's names."""
    return json.loads((ROOT / "kernels" / f"{name}.json").read_text())


def kernels(name: str) -> list:
    """Every kernel name whose device time family ``name`` counts: its own
    and those it shares with other families (``shared``)."""
    fam = family(name)
    return fam["kernels"] + fam.get("shared", [])


def csrc_kernels() -> set:
    """Every hand-written kernel's name, over all families."""
    return {k for f in sorted((ROOT / "kernels").glob("*.json")) for k in kernels(f.stem)}


def device_seconds(run: dict, names) -> float:
    """Device seconds of the traced window in kernels named in ``names``."""
    names = set(names)
    return sum(s for op, s in run["trace"]["by_op"] if kernel_name(op) in names)


def bound_seconds(run: dict, function: str) -> tuple[float, float, float]:
    """(least seconds, of which bound by operations, by bytes) of every call
    the window's steps make to ``function`` (``perfbench/bounds/``)."""
    mod, peaks = module("bounds", function), run["peaks"]
    total = by_ops = by_bytes = 0.0
    for n, shape in mod.calls(run):
        flops, nbytes = mod.count(shape, run["dtype_bytes"])
        t_ops, t_bytes = flops / peaks["flops_per_s"], nbytes / peaks["hbm_bytes_per_s"]
        total += n * max(t_ops, t_bytes)
        by_ops += n * t_ops * (t_ops >= t_bytes)
        by_bytes += n * t_bytes * (t_ops < t_bytes)
    return total, by_ops, by_bytes


def roofline(run: dict, name: str):
    """(share %, what bounds it) of kernel family ``name``: the least
    seconds of its functions' calls over its kernels' device seconds in the
    traced window (a kernel it shares with other families counted in
    full); None where the trace holds none of its own kernels."""
    if run.get("trace") is None:
        return None
    fam = family(name)
    if device_seconds(run, fam["kernels"]) <= 0:
        return None
    spent = device_seconds(run, kernels(name))
    parts = [bound_seconds(run, f) for f in fam["functions"]]
    least = sum(p[0] for p in parts)
    by = "operations" if sum(p[1] for p in parts) >= sum(p[2] for p in parts) else "bytes"
    return 100.0 * least / spent, f"bound by {by}"
