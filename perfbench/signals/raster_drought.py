"""A drought raster: a (steps, N, F) smooth seasonal field with spatially
correlated anomalies on a ``nodes_x`` x ``nodes_y`` raster (monthly steps).

A frozen copy of ``synth_drought`` of ``benchmarks/gambia_bench.py`` (lines
48-67, commit f33e1d7), with the raster's size and the generator as
arguments."""
import numpy as np


def make(rng: np.random.Generator, *, steps: int, nodes_x: int, nodes_y: int,
         features: int) -> np.ndarray:
    n = nodes_x * nodes_y
    gx = np.repeat(np.arange(nodes_x), nodes_y).astype(np.float32)
    t = np.arange(steps)[:, None]
    season = np.sin(2 * np.pi * t / 12.0 + gx[None, :] / nodes_x * 2)
    out = np.empty((steps, n, features), np.float32)
    for f in range(features):
        a = rng.normal(size=(steps, nodes_x, nodes_y)).astype(np.float32) * 0.3
        a = (a + np.roll(a, 1, 1) + np.roll(a, -1, 1)
             + np.roll(a, 1, 2) + np.roll(a, -1, 2)) / 5.0
        out[..., f] = 10 + 3 * season * (0.5 + 0.5 * f / features) + a.reshape(steps, n)
    return out
