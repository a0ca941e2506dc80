"""A road-like sensor graph of ``edges`` undirected links: sensors at
random points of a plane, a chain through them in x order (so every sensor
is reachable), the rest of the links between nearest neighbours."""
import numpy as np


def make(n: int, *, edges: int, rng: np.random.Generator, **_) -> np.ndarray:
    pts = rng.random((n, 2))
    order = np.argsort(pts[:, 0])
    a = np.zeros((n, n), np.float32)
    a[order[:-1], order[1:]] = a[order[1:], order[:-1]] = 1
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    d[np.tril_indices(n)] = np.inf
    need = edges - (n - 1)
    for flat in np.argsort(d, axis=None):
        if need == 0:
            break
        u, v = divmod(int(flat), n)
        if a[u, v] == 0:
            a[u, v] = a[v, u] = 1
            need -= 1
    return a
