"""K1, the BELL conv's weight-side backward: g_agg = g·Θᵀ, dA on every
active tile (what the softmax backward takes) and dΘ. Bytes: g, x, the
tile weights and Θ read once, dA and dΘ written once. The aggregation that
dΘ needs again is a recompute and not counted. Recounted from
chip_smoke.py's bell_bounds (commit f33e1d7) without hi/lo terms."""


def calls(run):
    return [(run["train_steps"], b) for b in run["blocks"]]


def count(s, w):
    B, H, N, C, T, Co = s["B"], s["K"], s["N"], s["C"], s["T"], s["Co"]
    A, BS, M = s["A"], s["BS"], s["C"] * s["T"]
    flops = 4 * B * N * H * M * Co + 2 * B * H * A * BS * BS * M
    nbytes = w * (B * N * Co * T + B * N * M + 2 * B * H * A * BS * BS + 2 * H * C * Co)
    return flops, nbytes
