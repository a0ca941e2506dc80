"""Offline windowed-dataset pipeline (numpy).

The port's own copy of ``dstagnn_drought_tpu/data/windowing.py``: the npz it
writes is bit-identical to the JAX package's. It re-implements the reference
preprocessing (reference: prepareData.py:6-161) with identical semantics and
on-disk format, so datasets prepared by either implementation are
interchangeable:

  * week/day/hour dependency windows: for each label index t, gather
    ``num_of_{weeks,days,hours}`` slices of length ``num_for_predict`` at
    offsets ``t − points_per_hour·units·i`` (units = 7·24 / 24 / 1), oldest
    first (prepareData.py:6-25);
  * samples stacked to (B, N, F, T), target keeps only the last feature
    (prepareData.py:99);
  * chronological 60/20/20 split (prepareData.py:107-112);
  * z-score normalization with *train-set* statistics over axes (0, 1, 3),
    per-feature (prepareData.py:149-161);
  * saved as ``<name>_r{h}_d{d}_w{w}_dstagnn.npz`` (prepareData.py:135-146).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def search_data(
    sequence_length: int,
    num_of_depend: int,
    label_start_idx: int,
    num_for_predict: int,
    units: int,
    points_per_hour: int,
):
    """Index ranges of the dependency windows for one label position.

    Returns a list of (start, end) pairs ordered oldest→newest, or None when
    the window would fall off the front/back of the series.
    """
    if points_per_hour < 0:
        raise ValueError("points_per_hour should be greater than 0!")
    if label_start_idx + num_for_predict > sequence_length:
        return None
    x_idx = []
    for i in range(1, num_of_depend + 1):
        start_idx = label_start_idx - points_per_hour * units * i
        if start_idx < 0:
            return None
        x_idx.append((start_idx, start_idx + num_for_predict))
    return x_idx[::-1]


def get_sample_indices(
    data_sequence: np.ndarray,
    num_of_weeks: int,
    num_of_days: int,
    num_of_hours: int,
    label_start_idx: int,
    num_for_predict: int,
    points_per_hour: int = 1,
):
    """One (week, day, hour, target) sample; entries are None when disabled
    or out of range. data_sequence: (T_total, N, F)."""
    if label_start_idx + num_for_predict > data_sequence.shape[0]:
        return None, None, None, None

    def gather(num_of_depend, units):
        idx = search_data(
            data_sequence.shape[0], num_of_depend, label_start_idx,
            num_for_predict, units, points_per_hour,
        )
        if not idx:
            return None
        return np.concatenate([data_sequence[i:j] for i, j in idx], axis=0)

    week_sample = gather(num_of_weeks, 7 * 24) if num_of_weeks > 0 else None
    if num_of_weeks > 0 and week_sample is None:
        return None, None, None, None
    day_sample = gather(num_of_days, 24) if num_of_days > 0 else None
    if num_of_days > 0 and day_sample is None:
        return None, None, None, None
    hour_sample = gather(num_of_hours, 1) if num_of_hours > 0 else None
    if num_of_hours > 0 and hour_sample is None:
        return None, None, None, None

    target = data_sequence[label_start_idx: label_start_idx + num_for_predict]
    return week_sample, day_sample, hour_sample, target


def normalization(train: np.ndarray, val: np.ndarray, test: np.ndarray):
    """Z-score with train statistics over axes (0,1,3), per feature."""
    assert train.shape[1:] == val.shape[1:] == test.shape[1:]
    mean = train.mean(axis=(0, 1, 3), keepdims=True)
    std = train.std(axis=(0, 1, 3), keepdims=True)
    # Constant features have zero variance; the reference divides anyway and
    # produces NaNs (prepareData.py:149-161). Normalize them to zero instead
    # (documented defect fix — the stored std keeps the raw value).
    safe_std = np.where(std == 0, 1.0, std)
    norm = lambda x: (x - mean) / safe_std
    return {"_mean": mean, "_std": std}, norm(train), norm(val), norm(test)


def windowed_npz_path(
    graph_signal_matrix_filename: str,
    num_of_hours: int,
    num_of_days: int,
    num_of_weeks: int,
) -> str:
    """The reference npz naming convention (prepareData.py:135-138,
    lib/utils1.py:295-297) — without the .npz extension."""
    base = os.path.basename(graph_signal_matrix_filename).split(".")[0]
    dirpath = os.path.dirname(graph_signal_matrix_filename)
    return os.path.join(
        dirpath,
        f"{base}_r{num_of_hours}_d{num_of_days}_w{num_of_weeks}_dstagnn",
    )


def read_and_generate_dataset(
    graph_signal_matrix_filename: str,
    num_of_weeks: int,
    num_of_days: int,
    num_of_hours: int,
    num_for_predict: int,
    points_per_hour: int = 1,
    save: bool = False,
    data: Optional[np.ndarray] = None,
):
    """Full pipeline: raw (T_total, N, F) signal → windowed, split, normalized
    dataset dict (and optionally the reference-format npz on disk)."""
    if data is None:
        data = np.load(graph_signal_matrix_filename)["data"]
    if data.ndim == 4:
        data = data.squeeze(axis=2)

    all_x, all_target, all_ts = [], [], []
    for idx in range(data.shape[0]):
        week, day, hour, target = get_sample_indices(
            data, num_of_weeks, num_of_days, num_of_hours, idx,
            num_for_predict, points_per_hour,
        )
        if week is None and day is None and hour is None:
            continue
        parts = [s for s in (week, day, hour) if s is not None]
        # (T_win, N, F) → (N, F, T_win), windows concatenated along time
        x = np.concatenate(parts, axis=0).transpose(1, 2, 0)
        all_x.append(x)
        all_target.append(target.transpose(1, 2, 0)[:, -1, :])  # last feature
        all_ts.append(idx)

    if not all_x:
        raise ValueError("no valid samples — series too short for the windows")

    x = np.stack(all_x).astype(np.float64)          # (B, N, F, T)
    target = np.stack(all_target).astype(np.float64)  # (B, N, T_pred)
    timestamps = np.asarray(all_ts)[:, None]

    s1 = int(len(x) * 0.6)
    s2 = int(len(x) * 0.8)
    stats, train_x, val_x, test_x = normalization(x[:s1], x[s1:s2], x[s2:])

    all_data = {
        "train": {"x": train_x, "target": target[:s1], "timestamp": timestamps[:s1]},
        "val": {"x": val_x, "target": target[s1:s2], "timestamp": timestamps[s1:s2]},
        "test": {"x": test_x, "target": target[s2:], "timestamp": timestamps[s2:]},
        "stats": stats,
    }

    if save:
        out = windowed_npz_path(
            graph_signal_matrix_filename, num_of_hours, num_of_days, num_of_weeks
        )
        np.savez_compressed(
            out,
            train_x=all_data["train"]["x"], train_target=all_data["train"]["target"],
            train_timestamp=all_data["train"]["timestamp"],
            val_x=all_data["val"]["x"], val_target=all_data["val"]["target"],
            val_timestamp=all_data["val"]["timestamp"],
            test_x=all_data["test"]["x"], test_target=all_data["test"]["target"],
            test_timestamp=all_data["test"]["timestamp"],
            mean=stats["_mean"], std=stats["_std"],
        )
    return all_data
