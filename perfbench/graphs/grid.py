"""The 4-neighbour raster graph: symmetric, row-major pixel order, so it
is banded, the structure the BELL path exploits. A frozen copy of
``grid_adjacency`` of ``benchmarks/gambia_bench.py`` (lines 68-82, commit
f33e1d7), built without a Python loop."""
import numpy as np


def make(n: int, *, nodes_x: int, nodes_y: int, **_) -> np.ndarray:
    if n != nodes_x * nodes_y:
        raise ValueError(f"{n} nodes on a {nodes_x} x {nodes_y} raster")
    a = np.zeros((n, n), np.float32)
    i = np.arange(n).reshape(nodes_x, nodes_y)
    for u, v in ((i[:-1, :], i[1:, :]), (i[:, :-1], i[:, 1:])):
        a[u.ravel(), v.ravel()] = a[v.ravel(), u.ravel()] = 1
    return a
