"""gtu_fused_roofline: the gtu_fused kernels' share of their roofline in the traced
window (perfbench/kernels/gtu_fused.json names them, perfbench/bounds/ counts
their functions); nothing where the trace holds none of them."""
from pbcore.layers import roofline


def read(run):
    return roofline(run, "gtu_fused")
