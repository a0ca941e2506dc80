"""bell_roofline: the bell kernels' share of their roofline in the traced
window (perfbench/kernels/bell.json names them, perfbench/bounds/ counts
their functions); nothing where the trace holds none of them."""
from pbcore.layers import roofline


def read(run):
    return roofline(run, "bell")
