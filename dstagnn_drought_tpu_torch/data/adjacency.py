"""Adjacency / graph file loaders (numpy).

Counterpart of ``dstagnn_drought_tpu/data/adjacency.py`` with the same
semantics; dense CSVs (headerless, comma-separated) are read by the
native parser where it is built, else numpy (``data/native.py``):

  * ``edge_list_adjacency`` — CSV edge list (from,to,cost) → dense 0/1
    adjacency; with an id file the ids are remapped and the matrix is
    symmetrized, without one it stays directed.
  * ``load_stag_adjacency`` — dense STAG csv, binarized (> 0).
  * ``load_strg_adjacency`` — dense STRG csv, binarized (> 0) → adj_pa.
  * ``load_dense_adjacency`` — dense csv, binarized, minus identity.
"""
from __future__ import annotations

import csv

import numpy as np

from dstagnn_drought_tpu_torch.data.native import load_dense_csv


def edge_list_adjacency(
    distance_csv: str, num_of_vertices: int, id_filename: str | None = None
) -> np.ndarray:
    A = np.zeros((num_of_vertices, num_of_vertices), dtype=np.float32)
    if id_filename:
        with open(id_filename) as f:
            id_map = {int(i): idx for idx, i in enumerate(f.read().strip().split("\n"))}
        with open(distance_csv) as f:
            f.readline()  # header
            for row in csv.reader(f):
                if len(row) != 3:
                    continue
                i, j = id_map[int(row[0])], id_map[int(row[1])]
                A[i, j] = 1
                A[j, i] = 1
        return A
    with open(distance_csv) as f:
        f.readline()
        for row in csv.reader(f):
            if len(row) != 3:
                continue
            # directed, like the reference's connectivity branch
            A[int(row[0]), int(row[1])] = 1
    return A


def read_dense_csv(path: str) -> np.ndarray:
    """Headerless dense CSV → (rows, cols) float64, through the native
    parser where it is built (numpy otherwise; ``data/native.py``)."""
    return load_dense_csv(path)


def load_stag_adjacency(path: str, num_of_vertices: int | None = None) -> np.ndarray:
    A = np.float64(read_dense_csv(path) > 0)
    if num_of_vertices is not None and A.shape[0] != num_of_vertices:
        raise ValueError(f"STAG matrix is {A.shape}, expected N={num_of_vertices}")
    return A


def load_strg_adjacency(path: str) -> np.ndarray:
    return np.float64(read_dense_csv(path) > 0)


def load_dense_adjacency(path: str, num_of_vertices: int) -> np.ndarray:
    A = np.int64(read_dense_csv(path) > 0)
    return A - np.identity(num_of_vertices)
