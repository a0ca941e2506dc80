"""Evaluation metrics with reference-identical masking semantics (numpy;
the port's own copy of ``dstagnn_drought_tpu/training/metrics.py``).

``masked_mape`` replicates lib/metrics.py:6-17 exactly: mask out entries equal
to ``null_val`` (or NaN), divide the mask by its mean (so masked-out entries
redistribute weight), nan_to_num the masked ratios, report percent.
MAE/RMSE match sklearn's mean_absolute_error / sqrt(mean_squared_error) as
used by the reference report (lib/utils1.py:487-506).
"""
from __future__ import annotations

import numpy as np


def masked_mape(y_true: np.ndarray, y_pred: np.ndarray, null_val=np.nan) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        if np.isnan(null_val):
            mask = ~np.isnan(y_true)
        else:
            mask = np.not_equal(y_true, null_val)
        mask = mask.astype("float32")
        mask /= np.mean(mask)
        mape = np.abs(np.divide((y_pred - y_true).astype("float32"), y_true))
        mape = np.nan_to_num(mask * mape)
        return float(np.mean(mape) * 100)


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.abs(y_true - y_pred)))


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def horizon_report(y_true: np.ndarray, y_pred: np.ndarray, null_val=0) -> dict:
    """Per-horizon + overall MAE/RMSE/MAPE (reference lib/utils1.py:487-506).

    y_true/y_pred: (B, N, T_pred).
    """
    T = y_pred.shape[2]
    per = []
    for i in range(T):
        per.append(
            {
                "horizon": i + 1,
                "mae": mae(y_true[:, :, i], y_pred[:, :, i]),
                "rmse": rmse(y_true[:, :, i], y_pred[:, :, i]),
                "mape": masked_mape(y_true[:, :, i], y_pred[:, :, i], null_val),
            }
        )
    overall = {
        "mae": mae(y_true.reshape(-1), y_pred.reshape(-1)),
        "rmse": rmse(y_true.reshape(-1), y_pred.reshape(-1)),
        "mape": masked_mape(y_true.reshape(-1, 1), y_pred.reshape(-1, 1), null_val),
    }
    return {"per_horizon": per, "overall": overall}
