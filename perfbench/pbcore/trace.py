"""The traced run: a torch.profiler window over CPU and CUDA, reduced to
device intervals, host spans and the sums the per-layer readers take.

The kernels of a CUDA graph's replays appear in the trace by name, one
record a launch, as eager launches do. The busy time is the union of the
device intervals (operations that overlap on two streams count once), and
an idle gap is labelled by the harness span and the shortest host event
that cover its start.
"""
from __future__ import annotations

import contextlib
import re

import torch

SPAN = "perfbench."  # the harness's own record_function spans


@contextlib.contextmanager
def profiled(enabled: bool):
    """A torch.profiler region over CPU and CUDA where ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def events(prof) -> tuple[list, list]:
    """(device ops, host events), each a list of (name, start_ns, end_ns),
    sorted by start. Device ops are the CUDA-side records that are not the
    device spans of record_function regions."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        row = (e.name(), start, start + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", lambda: False)():
                device.append(row)
        else:
            host.append(row)
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return device, host


def union(intervals, lo: int, hi: int) -> list:
    """The merged [start, end) intervals of ``intervals`` clipped to [lo, hi)."""
    out = []
    for _, s, e in sorted(intervals, key=lambda r: r[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labeller(host):
    """A function of t (a gap's middle): what the host was doing at t, as the harness spans
    (outermost first) and the shortest other host event that cover t."""
    import bisect

    spans = [r for r in host if r[0].startswith(SPAN)]
    rest = [r for r in host if not r[0].startswith(SPAN)]
    starts = [r[1] for r in rest]

    def label(t: int) -> str:
        where = [n[len(SPAN):] for n, s, e in spans if s <= t < e and n != SPAN + "window"]
        inner = None
        i = bisect.bisect_right(starts, t) - 1
        for name, s, e in rest[max(0, i - 256):i + 1][::-1]:
            if e > t and (inner is None or e - s < inner[1]):
                inner = (name, e - s)
        head = "/".join(where) or "window"
        return head if inner is None else f"{head}:{inner[0]}"

    return label


def window_of(host) -> tuple[int, int]:
    """[start, end) of the harness's ``perfbench.window`` span."""
    for name, s, e in host:
        if name == SPAN + "window":
            return s, e
    raise RuntimeError("the trace holds no perfbench.window span")


# gaps shorter than this are launch latency inside a graph replay, and are
# summed under one label instead of being looked up one by one
SHORT_GAP_NS = 20_000


def reduce(prof, top: int = 10) -> dict:
    """The traced window (the ``perfbench.window`` span) of ``prof``: busy
    seconds, window seconds, device seconds by op name, and the idle gaps
    by what the host was doing (each list sorted, longest first)."""
    device, host = events(prof)
    lo_ns, hi_ns = window_of(host)
    device = [r for r in device if r[2] > lo_ns and r[1] < hi_ns]
    merged = union(device, lo_ns, hi_ns)
    busy = sum(e - s for s, e in merged)
    by_op: dict = {}
    for name, s, e in device:
        by_op[name] = by_op.get(name, 0) + (min(e, hi_ns) - max(s, lo_ns))
    gaps: dict = {}
    label = _labeller(host)
    edges = [lo_ns] + [x for iv in merged for x in iv] + [hi_ns]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            key = label((s + e) // 2) if e - s >= SHORT_GAP_NS else "gaps under 20 us"
            gaps[key] = gaps.get(key, 0) + (e - s)
    rank = lambda d: sorted(((k, v / 1e9) for k, v in d.items()), key=lambda kv: -kv[1])
    return {"busy_s": busy / 1e9, "window_s": (hi_ns - lo_ns) / 1e9,
            "by_op": rank(by_op), "gaps": rank(gaps)[:top]}


def kernel_name(op: str) -> str | None:
    """The ``__global__`` function name of a device op's record (``void
    ns::(anonymous namespace)::f<...>(...)`` → ``f``), or None where the
    record is no such signature (a library kernel's bare name)."""
    m = re.match(r"(?:void\s+)?(?:[\w:]+::)?(\w+)\s*[<(]",
                 op.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else None
