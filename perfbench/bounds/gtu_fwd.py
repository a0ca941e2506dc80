"""The fused GTU forward: three gated (1, k) convs, k = 3, 5, 7, C → 2C
channels over time, concatenated in time (3T - 12 steps). Operations: the
useful taps of the convs. Bytes: x and the output once, the taps and
biases once. Recounted from chip_smoke.py's gtu_bounds (commit f33e1d7)."""

KS = (3, 5, 7)


def calls(run):
    n = run["train_steps"] + run["val_batches"]
    return [(n, b) for b in run["blocks"]]


def flops(s):
    C, T = s["Ct"], s["T"]
    return 2 * s["B"] * s["N"] * sum((T - k + 1) * k for k in KS) * C * 2 * C


def count(s, w):
    C, T, BN = s["Ct"], s["T"], s["B"] * s["N"]
    weights = sum(2 * C * C * k for k in KS) + 3 * 2 * C
    return flops(s), w * (BN * C * T + BN * (3 * T - 12) * C + weights)
