"""cheb_sat, the dense attention-modulated Chebyshev aggregation (forward
only; its backward is tensor ops): per block and call,
A = T_k ⊙ softmax_i(S + adj_pa ⊙ mask_k) and agg_j = Σ_i A[i, j] x_i.
Operations: the (K, N, N) by (N, C·T) product and ~6 a score for the bias,
softmax and modulation. Bytes: the scores, the bias and Chebyshev planes
and x read once, the (B, K, N, C·T) aggregation written once.
Recounted from chip_smoke.py's cheb_sat_bound (commit f33e1d7) without its
design's bf16 hi/lo terms."""


def calls(run):
    n = run["train_steps"] + run["val_batches"]
    return [(n, b) for b in run["blocks"]]


def count(s, w):
    B, K, N, M = s["B"], s["K"], s["N"], s["C"] * s["T"]
    flops = 2 * B * K * N * N * M + 6 * B * K * N * N
    nbytes = w * (B * K * N * N + 2 * K * N * N + B * N * M + B * K * N * M)
    return flops, nbytes
