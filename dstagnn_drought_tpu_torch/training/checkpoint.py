"""Checkpoints of the port: one ``epoch_<e>.pt`` per save.

Counterpart of ``dstagnn_drought_tpu/training/checkpoint.py`` with the
port's own format: a ``torch.save`` dict of the model ``state_dict``, the
optimizer ``state_dict``, the dropout generator's state and metadata
(epoch, best-val loss). Restoring all of it is a true resume. A run on a
mesh saves whole tensors, gathered from the ranks' slices, and adds every
data rank's generator state (``generators``). The
run-directory naming keeps the reference convention
``<root>/<dataset>/<model>_<h>h<d>d<w>w_channel<C>_<lr>``.
"""
from __future__ import annotations

import os
import re

import torch


def run_dir(
    root: str,
    dataset_name: str,
    model_name: str,
    num_of_hours: int,
    num_of_days: int,
    num_of_weeks: int,
    in_channels: int,
    learning_rate: float,
) -> str:
    folder = (
        f"{model_name}_{num_of_hours}h{num_of_days}d{num_of_weeks}w"
        f"_channel{in_channels}_{learning_rate}"
    )
    return os.path.join(root, dataset_name, folder)


def checkpoint_path(path_dir: str, epoch: int) -> str:
    return os.path.join(path_dir, f"epoch_{epoch}.pt")


def save_checkpoint(
    path_dir: str,
    epoch: int,
    *,
    model_state: dict,
    optimizer_state: dict | None = None,
    generator_state: torch.Tensor | None = None,
    metadata: dict | None = None,
    generators: torch.Tensor | None = None,
) -> str:
    """``generators`` (D, ·): every data rank's generator state, kept
    beside rank 0's ``generator`` when the run has a data axis."""
    os.makedirs(path_dir, exist_ok=True)
    path = checkpoint_path(path_dir, epoch)
    torch.save({
        "model": model_state,
        "optimizer": optimizer_state,
        "generator": generator_state,
        "meta": {"epoch": epoch, **(metadata or {})},
        **({"generators": generators} if generators is not None else {}),
    }, path)
    return path


def restore_checkpoint(path: str, map_location=None) -> dict:
    """{"model", "optimizer", "generator", "meta"} (and "generators" where
    saved) as saved."""
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(path_dir: str) -> str | None:
    if not os.path.isdir(path_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(path_dir):
        m = re.fullmatch(r"epoch_(\d+)\.pt", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(path_dir, name)
    return best
