"""cheb_sat_roofline: the cheb_sat kernels' share of their roofline in the traced
window (perfbench/kernels/cheb_sat.json names them, perfbench/bounds/ counts
their functions); nothing where the trace holds none of them."""
from pbcore.layers import roofline


def read(run):
    return roofline(run, "cheb_sat")
