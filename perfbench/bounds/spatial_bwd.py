"""The fused dense spatial middle's backward: the gradients of the TAt
output, of every weight and mask, and of x where the block's input takes
one. The dense products and the scores twice, the aggregation once for dA
and once more for dx where x takes a gradient (recompute not counted).
Bytes: the TAt output, x, the output's cotangent, the weights and the
planes read once; the gradients written once."""
from pbcore.layers import module

_fwd = module("bounds", "spatial_fwd")


def calls(run):
    return [(run["train_steps"], b) for b in run["blocks"]]


def count(s, w):
    B, N, F, T, C, Co, K = s["B"], s["N"], s["F"], s["T"], s["C"], s["Co"], s["K"]
    dense, scores, agg = _fwd.parts(s)
    flops = 2 * dense + 2 * scores + agg * (2 if s["needs_dx"] else 1)
    dx = B * N * C * T if s["needs_dx"] else 0
    nbytes = w * (2 * B * F * T * N + B * N * C * T + B * N * Co * T + dx
                  + 2 * _fwd.weights(s) + (K + 1) * N * N)
    return flops, nbytes
