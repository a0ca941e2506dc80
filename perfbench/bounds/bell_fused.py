"""F, the BELL conv's forward on the active tiles (A tiles of BS x BS):
scores Q·Kᵀ on each tile, the neighbourhood softmax, the SpMM with x, the
Θ mix over the K heads and the ReLU. Bytes: q and k (B, N, H, d_k), the
bias and Chebyshev tiles, x and Θ read once, the output written once.
Recounted from chip_smoke.py's bell_bounds (commit f33e1d7) without its
design's bf16 hi/lo terms; the q and k projections are outside the
kernel and not counted."""


def calls(run):
    n = run["train_steps"] + run["val_batches"]
    return [(n, b) for b in run["blocks"]]


def count(s, w):
    B, H, N, dk, C, T, Co = s["B"], s["K"], s["N"], s["dk"], s["C"], s["T"], s["Co"]
    A, BS, M = s["A"], s["BS"], s["C"] * s["T"]
    flops = 2 * B * H * A * BS * BS * (dk + M) + 2 * B * N * H * M * Co
    nbytes = w * (2 * B * N * H * dk + 2 * A * H * BS * BS + B * N * M + B * N * Co * T
                  + H * C * Co)
    return flops, nbytes
