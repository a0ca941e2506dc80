"""step_mfu: the model's operations in the window (its training steps and
validation batches, perfbench/bounds/dstagnn_step.py) over the window's
seconds at the card's peak, in %."""
from pbcore.layers import module


def read(run):
    flops = module("bounds", "dstagnn_step").flops(run)
    return 100.0 * flops / (run["window_s"] * run["peaks"]["flops_per_s"])
