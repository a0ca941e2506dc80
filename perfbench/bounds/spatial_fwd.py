"""The fused dense spatial middle's forward: the pre-conv (T·F → d_model),
the spatial embedding's LayerNorm, the SAt projections and (K, N, N)
scores, the bias, the softmax over sources, the Chebyshev modulation, the
aggregation of x (C·T features), the Θ mix and the ReLU. Bytes: the TAt
output and x read once, the output written once, the weights, the masks,
adj_pa and the Chebyshev planes read once. Recounted from chip_smoke.py's
spatial_bounds (commit f33e1d7) without the design's hi/lo terms."""


def parts(s):
    B, N, F, T, C, Co, d, K, dk = (s["B"], s["N"], s["F"], s["T"], s["C"], s["Co"], s["d"],
                                   s["K"], s["dk"])
    dense = 2 * B * N * F * T * d + 2 * B * N * d * 2 * K * dk + 2 * B * K * N * C * T * Co
    scores = 2 * B * K * N * N * dk
    agg = 2 * B * K * N * N * C * T
    return dense, scores, agg


def weights(s):
    N, F, T, C, Co, d, K, dk = (s["N"], s["F"], s["T"], s["C"], s["Co"], s["d"], s["K"],
                                s["dk"])
    return F * T * d + 3 * d + N * d + 2 * K * dk * d + K * N * N + K * C * Co


def calls(run):
    n = run["train_steps"] + run["val_batches"]
    return [(n, b) for b in run["blocks"]]


def count(s, w):
    B, N, F, T, C, Co, K = s["B"], s["N"], s["F"], s["T"], s["C"], s["Co"], s["K"]
    dense, scores, agg = parts(s)
    flops = dense + scores + agg + 8 * B * K * N * N
    nbytes = w * (B * F * T * N + B * N * C * T + B * N * Co * T + weights(s)
                  + (K + 1) * N * N)
    return flops, nbytes
