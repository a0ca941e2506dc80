"""The fused temporal attention's forward on (B·F, T, N) tokens: the Q, K,
V projections, the (T, T) scores with the incoming residual, the softmax,
the context, the out-projection and the residual LayerNorm. Bytes: x and
the incoming scores read once, the output and the scores written once, the
weights once. Recounted from chip_smoke.py's tat_bounds (commit f33e1d7)
without the design's hi/lo terms and intermediates."""


def matmuls(s):
    BF, T, N, H, dk, dv = s["B"] * s["F"], s["T"], s["N"], s["H"], s["dk"], s["dv"]
    proj = 2 * BF * T * N * H * (2 * dk + dv) + 2 * BF * T * H * dv * N
    attention = 2 * BF * H * T * T * (dk + dv)
    return proj, attention


def weights(s):
    N, H, dk, dv = s["N"], s["H"], s["dk"], s["dv"]
    return N * H * (2 * dk + dv) + H * dv * N + 2 * N


def calls(run):
    n = run["train_steps"] + run["val_batches"]
    return [(n, b) for b in run["blocks"]]


def count(s, w):
    BF, T, N, H = s["B"] * s["F"], s["T"], s["N"], s["H"]
    proj, attention = matmuls(s)
    flops = proj + attention + 5 * BF * H * T * T + 10 * BF * T * N
    nbytes = w * (2 * BF * T * N + 2 * BF * H * T * T + weights(s))
    return flops, nbytes
