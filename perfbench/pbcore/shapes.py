"""The shapes a run's functions see, for the operation and byte counts of
``perfbench/bounds/``: one dict a block, from the configuration's model
section and the batch. Each function's bound file reads what it needs."""
from __future__ import annotations


def blocks(spec: dict, batch: int) -> list:
    """One dict a block: B, N, T, F (the block's input features), C (the
    channels its conv aggregates), Co (nb_chev_filter), Ct (nb_time_filter),
    K, H, dk, dv, d, P, and ``needs_dx``: whether anything upstream of the
    block's input takes a gradient (not for the raw input of block 1)."""
    first = (spec["in_channels"], spec["in_channels"])
    rest = (spec["nb_time_filter"], spec["nb_chev_filter"])
    out = []
    for i, (F, C) in enumerate([first] + [rest] * (spec["nb_block"] - 1)):
        out.append({"B": batch, "N": spec["num_of_vertices"], "T": spec["len_input"], "F": F,
                    "C": C, "Co": spec["nb_chev_filter"], "Ct": spec["nb_time_filter"],
                    "K": spec["K"], "H": spec["n_heads"], "dk": spec["d_k"], "dv": spec["d_v"],
                    "d": spec["d_model"], "P": spec["num_for_predict"],
                    "nb_block": spec["nb_block"], "needs_dx": i > 0})
    return out
