"""Parameter initializers mirroring the reference's init scheme.

Counterpart of ``dstagnn_drought_tpu/models/layers.py``. The reference
re-initializes *every* parameter after construction: ndim > 1 →
xavier_uniform, ndim <= 1 → U(0, 1), including biases and LayerNorm affine
parameters. The draws come from an explicit ``torch.Generator``; exact
weight parity with the JAX package goes through ``params_from_jax``.
"""
from __future__ import annotations

import torch
from torch import nn


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``nn.init.xavier_uniform_`` (gain=1): for conv weights (O, I, kh, kw),
    fan_in = I·kh·kw, fan_out = O·kh·kw."""
    if t.ndim < 2:
        raise ValueError("xavier_uniform needs ndim >= 2")
    receptive = 1
    for s in t.shape[2:]:
        receptive *= s
    bound = (6.0 / (t.shape[1] * receptive + t.shape[0] * receptive)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def ref_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``nn.init.uniform_`` default U(0, 1)."""
    with torch.no_grad():
        return t.uniform_(0.0, 1.0, generator=generator)


def init_like_reference_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every parameter of ``module`` like the reference's loop."""
    for p in module.parameters():
        if p.ndim > 1:
            xavier_uniform_(p, generator)
        else:
            ref_uniform_(p, generator)
