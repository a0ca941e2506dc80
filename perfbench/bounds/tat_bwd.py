"""The fused temporal attention's backward: the weights' gradients and the
scores' and x's (x's only where the block's input takes a gradient), twice
the forward's products for the weight and input sides (recompute not
counted). Bytes: x, the output's and the scores' cotangents and the
weights read once; dx, the incoming scores' gradient and the weights'
gradients written once."""
from pbcore.layers import module

_fwd = module("bounds", "tat_fwd")


def calls(run):
    return [(run["train_steps"], b) for b in run["blocks"]]


def count(s, w):
    BF, T, N, H = s["B"] * s["F"], s["T"], s["N"], s["H"]
    proj, attention = _fwd.matmuls(s)
    # the projections' weight side always, their input side where x takes
    # a gradient; the attention's two products always
    flops = proj * (2 if s["needs_dx"] else 1) + 2 * attention
    dx = BF * T * N if s["needs_dx"] else 0
    nbytes = w * (2 * BF * T * N + 2 * BF * H * T * T + dx + 2 * _fwd.weights(s))
    return flops, nbytes
