"""MSTGCN — ASTGCN with both attention mechanisms removed; counterpart of
``dstagnn_drought_tpu/models/mstgcn.py``. Its blocks hold no ``tat``/``sat``
parameters and run the plain Chebyshev conv."""
from __future__ import annotations

import torch

from dstagnn_drought_tpu_torch.models import astgcn
from dstagnn_drought_tpu_torch.models.astgcn import params_from_jax  # noqa: F401
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec


def make_model(spec: ModelSpec, adj_merge, adj_pa, *, seed: int = 0,
               device: torch.device | str = "cuda"):
    return astgcn.make_model(spec, adj_merge, adj_pa, seed=seed, device=device,
                             attention=False)
