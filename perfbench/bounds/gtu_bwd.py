"""The fused GTU backward: dx and the taps' and biases' gradients, twice
the forward's products (the recompute of the forward is not counted).
Bytes: x, g and the taps read once, dx and the gradients written once.
Recounted from chip_smoke.py's gtu_bounds (commit f33e1d7)."""
from pbcore.layers import module

_fwd = module("bounds", "gtu_fwd")


def calls(run):
    return [(run["train_steps"], b) for b in run["blocks"]]


def count(s, w):
    C, T, BN = s["Ct"], s["T"], s["B"] * s["N"]
    weights = sum(2 * C * C * k for k in _fwd.KS) + 3 * 2 * C
    return 2 * _fwd.flops(s), w * (2 * BN * C * T + BN * (3 * T - 12) * C + 2 * weights)
