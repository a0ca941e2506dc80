"""spatial_fused_roofline: the spatial_fused kernels' share of their roofline in the traced
window (perfbench/kernels/spatial_fused.json names them, perfbench/bounds/ counts
their functions); nothing where the trace holds none of them."""
from pbcore.layers import roofline


def read(run):
    return roofline(run, "spatial_fused")
