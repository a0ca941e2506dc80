"""Windowed-dataset loading and batch plans.

Counterpart of ``dstagnn_drought_tpu/data/dataset.py``. The splits stay numpy
arrays here; the trainer moves each split to its device once and gathers a
batch there by an index vector. ``batch_indices`` is the JAX package's
numpy-seeded plan, copied exactly, so both trainers see the same batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from dstagnn_drought_tpu_torch.data.windowing import windowed_npz_path


@dataclasses.dataclass
class Split:
    x: np.ndarray       # (B_total, N, F, T) float32
    target: np.ndarray  # (B_total, N, T_pred) float32

    def __len__(self):
        return self.x.shape[0]


@dataclasses.dataclass
class ArrayDataset:
    train: Split
    val: Split
    test: Split
    mean: np.ndarray
    std: np.ndarray

    def batch_indices(
        self, split: str, batch_size: int, *, shuffle: bool, seed: int | None = None
    ) -> tuple[np.ndarray, int]:
        """Static-shape batch index plan for one epoch.

        Returns (indices, n_valid): ``indices`` is (num_batches, batch_size);
        the final batch is padded by repeating index 0; ``n_valid`` is the
        true sample count (padded rows get zero loss weight and are sliced
        off predictions).
        """
        n = len(getattr(self, split))
        order = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(order)
        nb = -(-n // batch_size)
        padded = np.zeros((nb * batch_size,), dtype=np.int32)
        padded[:n] = order
        return padded.reshape(nb, batch_size), n


def load_windowed_dataset(
    graph_signal_matrix_filename: str,
    num_of_hours: int,
    num_of_days: int,
    num_of_weeks: int,
) -> ArrayDataset:
    """Read a reference-format ``*_dstagnn.npz``."""
    path = windowed_npz_path(
        graph_signal_matrix_filename, num_of_hours, num_of_days, num_of_weeks
    ) + ".npz"
    with np.load(path) as f:
        as32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
        return ArrayDataset(
            train=Split(as32(f["train_x"]), as32(f["train_target"])),
            val=Split(as32(f["val_x"]), as32(f["val_target"])),
            test=Split(as32(f["test_x"]), as32(f["test_target"])),
            mean=np.asarray(f["mean"]),
            std=np.asarray(f["std"]),
        )
