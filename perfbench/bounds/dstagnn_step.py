"""The whole model's operations, for ``step_mfu``: the products of every
block (the TAt's projections, scores and context; the pre-conv; the SAt
projections and scores; the Chebyshev aggregation; the Θ mix; the GTU
convs; fcmy; the residual conv where the width changes) and of the head,
counted from shapes, with no recompute. Scores and aggregation count the
(N, N) plane on the dense path and the active tiles (A tiles of BS x BS) on
the BELL path. A training step is three forwards (the backward's input and
weight sides), a validation batch one."""

KS = (3, 5, 7)


def forward(s):
    B, N, F, T, C, Co, Ct = s["B"], s["N"], s["F"], s["T"], s["C"], s["Co"], s["Ct"]
    H, dk, dv, d, K = s["H"], s["dk"], s["dv"], s["d"], s["K"]
    plane = s["A"] * s["BS"] ** 2 if s.get("A") else N * N
    f = (2 * F * T * N * H * (2 * dk + dv) + 2 * F * H * T * T * (dk + dv)
         + 2 * F * T * H * dv * N                       # TAt
         + 2 * N * F * T * d                             # pre-conv
         + 2 * N * d * 2 * K * dk + 2 * K * plane * dk   # SAt
         + 2 * K * plane * C * T                         # aggregation
         + 2 * K * N * C * T * Co                        # Θ mix
         + 2 * N * sum((T - k + 1) * k for k in KS) * Ct * 2 * Ct
         + 2 * N * Ct * (3 * T - 12) * T                 # fcmy
         + (2 * N * Ct * F * T if F != Ct else 0))       # residual conv
    return B * f


def head(s):
    return s["B"] * (2 * s["N"] * s["T"] * s["nb_block"] * s["Ct"] * 128
                     + 2 * s["N"] * 128 * s["P"])


def flops(run):
    """Operations of the run's training steps and validation batches."""
    step = sum(forward(b) for b in run["blocks"]) + head(run["blocks"][0])
    return 3 * step * run["train_steps"] + step * run["val_batches"]
