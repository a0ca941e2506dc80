"""tat_fused_roofline: the tat_fused kernels' share of their roofline in the traced
window (perfbench/kernels/tat_fused.json names them, perfbench/bounds/ counts
their functions); nothing where the trace holds none of them."""
from pbcore.layers import roofline


def read(run):
    return roofline(run, "tat_fused")
