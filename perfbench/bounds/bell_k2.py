"""K2, the BELL conv's dx: the tile weights' transpose times g_agg, summed
over the K heads. Bytes: g, the tile weights and Θ read once, dx written
once. g_agg, which K1 counts, is not counted again. Recounted from
chip_smoke.py's bell_bounds (commit f33e1d7) without hi/lo terms."""


def calls(run):
    return [(run["train_steps"], b) for b in run["blocks"]]


def count(s, w):
    B, H, N, C, T, Co = s["B"], s["K"], s["N"], s["C"], s["T"], s["Co"]
    A, BS, M = s["A"], s["BS"], s["C"] * s["T"]
    flops = 2 * B * H * A * BS * BS * M
    nbytes = w * (B * N * Co * T + B * H * A * BS * BS + H * C * Co + B * N * M)
    return flops, nbytes
