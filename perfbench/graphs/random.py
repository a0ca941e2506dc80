"""A random graph with no spatial order: each node pair linked with
probability ``density`` (drawn for i < j and mirrored, so the graph is
symmetric as a top-k STAG is), no self loops. At N = 2139 and 1% every BELL
tile of 128 holds edges: the long slot loop, where the raster's band keeps
49 of 289 tiles. The draw is ``random_adjacency`` of ``chip_smoke.py``
(commit f33e1d7), kept above the diagonal."""
import numpy as np


def make(n: int, *, density: float, rng: np.random.Generator, **_) -> np.ndarray:
    a = np.triu(rng.random((n, n)) < density, k=1)
    return (a | a.T).astype(np.float32)
