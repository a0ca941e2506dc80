"""Legacy-format compatibility: the reference's older loader and the
STGCN-era helpers that survive in its library layer. Counterpart (a copy,
host numpy) of ``dstagnn_drought_tpu/data/legacy.py``.

Covers two components of the reference inventory (SURVEY.md §2 C4'/C12):

* ``load_windowed_dataset_legacy`` — the older ``load_graphdata_channel1``
  variant (reference lib/utils.py:301-377): reads the ``_mhastigcn``-suffixed
  npz and keeps only feature 0 of x (and of the stored mean/std).
* ``load_csv_splits`` / ``sliding_window_transform`` — the STGCN-era CSV
  split loader and sliding-window transform (reference
  lib/dataloader.py:25-47), vectorized instead of the reference's Python
  copy loop.
* ``evaluate_model`` / ``evaluate_metric`` + ``ZScaler`` — the STGCN-era
  evaluation helpers (reference lib/utility.py:101-132): sample-weighted MSE,
  and MAE/RMSE/WMAPE on inverse-transformed predictions.

All of it is host-side numpy — these paths exist for drop-in compatibility
with data produced for the reference, not for the hot loop.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split


def legacy_npz_path(
    graph_signal_matrix_filename: str,
    num_of_hours: int,
    num_of_days: int,
    num_of_weeks: int,
) -> str:
    """``<dir>/<base>_r{h}_d{d}_w{w}_mhastigcn`` (reference lib/utils.py:328)."""
    base = os.path.basename(graph_signal_matrix_filename).split(".")[0]
    dirpath = os.path.dirname(graph_signal_matrix_filename)
    return os.path.join(
        dirpath,
        f"{base}_r{num_of_hours}_d{num_of_days}_w{num_of_weeks}_mhastigcn",
    )


def load_windowed_dataset_legacy(
    graph_signal_matrix_filename: str,
    num_of_hours: int,
    num_of_days: int,
    num_of_weeks: int,
) -> ArrayDataset:
    """Legacy loader: ``_mhastigcn`` suffix, x sliced to feature 0 only
    (reference lib/utils.py:334-346); targets are untouched real values."""
    path = legacy_npz_path(
        graph_signal_matrix_filename, num_of_hours, num_of_days, num_of_weeks
    ) + ".npz"
    f = np.load(path)
    as32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    first = lambda a: a[:, :, 0:1, :]
    return ArrayDataset(
        train=Split(as32(first(f["train_x"])), as32(f["train_target"])),
        val=Split(as32(first(f["val_x"])), as32(f["val_target"])),
        test=Split(as32(first(f["test_x"])), as32(f["test_target"])),
        mean=np.asarray(f["mean"])[:, :, 0:1, :],
        std=np.asarray(f["std"])[:, :, 0:1, :],
    )


# ---------------------------------------------------------------------------
# STGCN-era CSV pipeline (reference lib/dataloader.py:25-47)
# ---------------------------------------------------------------------------

def load_csv_splits(
    file_path: str, len_train: int, len_val: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chronological train/val/test split of a header-less (T, N) CSV
    (reference lib/dataloader.py:25-30)."""
    data = np.genfromtxt(file_path, delimiter=",", dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    train = data[:len_train]
    val = data[len_train : len_train + len_val]
    test = data[len_train + len_val :]
    return train, val, test


def sliding_window_transform(
    data: np.ndarray, n_his: int, n_pred: int
) -> tuple[np.ndarray, np.ndarray]:
    """All (history, prediction) window pairs over a (T, N) series.

    Reference semantics (lib/dataloader.py:32-47): ``num = T - n_his - n_pred``
    windows; x[i] = data[i : i+n_his] as (1, n_his, N); y[i] =
    data[i+n_his : i+n_his+n_pred]. Vectorized via as_strided instead of the
    reference's per-window Python copy loop.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    T, N = data.shape
    num = T - n_his - n_pred
    if num <= 0:
        raise ValueError(
            f"series of length {T} too short for n_his={n_his} n_pred={n_pred}"
        )
    s0, s1 = data.strides
    windows = np.lib.stride_tricks.as_strided(
        data, shape=(num, n_his + n_pred, N), strides=(s0, s0, s1)
    )
    x = windows[:, None, :n_his, :].copy()          # (num, 1, n_his, N)
    y = windows[:, n_his : n_his + n_pred, :].copy()  # (num, n_pred, N)
    return x, y


# ---------------------------------------------------------------------------
# STGCN-era evaluation (reference lib/utility.py:101-132)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ZScaler:
    """sklearn-StandardScaler-shaped z-score scaler, as the reference's
    ``evaluate_metric`` expects (lib/utility.py:115-132)."""

    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def fit(cls, data: np.ndarray) -> "ZScaler":
        return cls(mean=np.mean(data), std=np.std(data))

    def transform(self, a: np.ndarray) -> np.ndarray:
        return (a - self.mean) / self.std

    def inverse_transform(self, a: np.ndarray) -> np.ndarray:
        return a * self.std + self.mean


def _iter_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    for i in range(0, x.shape[0], batch_size):
        yield x[i : i + batch_size], y[i : i + batch_size]


def evaluate_model(
    predict_fn, n_pred: int, x: np.ndarray, y: np.ndarray, batch_size: int = 64
) -> float:
    """Sample-weighted mean MSE over batched predictions (reference
    lib/utility.py:101-113). ``predict_fn(xb) -> (B, n_pred, N)``-reshapable."""
    l_sum, n = 0.0, 0
    for xb, yb in _iter_batches(x, y, batch_size):
        pred = np.asarray(predict_fn(xb)).reshape(len(xb), n_pred, -1)
        l_sum += float(np.mean((pred - yb) ** 2)) * yb.shape[0]
        n += yb.shape[0]
    return l_sum / n


def evaluate_metric(
    predict_fn,
    n_pred: int,
    x: np.ndarray,
    y: np.ndarray,
    scaler: ZScaler,
    batch_size: int = 64,
) -> tuple[float, float, float]:
    """(MAE, RMSE, WMAPE) on inverse-transformed values (reference
    lib/utility.py:115-132; WMAPE = Σ|err| / Σy)."""
    abs_err, ys = [], []
    for xb, yb in _iter_batches(x, y, batch_size):
        yt = scaler.inverse_transform(np.asarray(yb)).reshape(-1)
        yp = scaler.inverse_transform(
            np.asarray(predict_fn(xb)).reshape(len(xb), n_pred, -1)
        ).reshape(-1)
        abs_err.append(np.abs(yt - yp))
        ys.append(yt)
    d = np.concatenate(abs_err)
    yt = np.concatenate(ys)
    mae = float(d.mean())
    rmse = float(np.sqrt((d**2).mean()))
    wmape = float(d.sum() / yt.sum())
    return mae, rmse, wmape
