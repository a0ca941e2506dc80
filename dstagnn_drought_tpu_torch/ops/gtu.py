"""Gated Temporal convolution Unit (GTU).

Counterpart of ``dstagnn_drought_tpu/ops/gtu.py``: tanh(p) ⊙ sigmoid(q) over
a width-k valid conv along time (Conv2d(C → 2C, kernel (1,k), stride
(1, time_strides)); the first C output channels are p, the last C are q).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# T at or above this switches the GTU to the im2col matmul formulation, as
# in the JAX package (its threshold, kept so both take the same branch).
_IM2COL_MIN_T = 48


def conv2d_nchw(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Valid 2-D convolution, NCHW activations / OIHW weights."""
    return F.conv2d(x, w, b, stride=stride)


def _im2col_cols(xt: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """(…, T, C) → (…, T_out, k·C): the k stacked time windows."""
    T = xt.shape[-2]
    T_out = (T - k) // s + 1
    return torch.cat(
        [xt[..., kk: kk + (T_out - 1) * s + 1: s, :] for kk in range(k)], dim=-1
    )


def _im2col_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2C, C, 1, k) OIHW → (k·C, 2C) matching ``_im2col_cols``."""
    k = w.shape[-1]
    return w[:, :, 0, :].permute(2, 1, 0).reshape(k * w.shape[1], -1).to(dtype)


def _gate(y: torch.Tensor, in_channels: int, dim: int) -> torch.Tensor:
    p, q = y.split([in_channels, y.shape[dim] - in_channels], dim=dim)
    return torch.tanh(p) * torch.sigmoid(q)


def gtu(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    in_channels: int,
    time_strides: int = 1,
) -> torch.Tensor:
    """x: (B, C, N, T); w: (2C, C, 1, k); b: (2C,) →
    (B, C, N, (T-k)//time_strides + 1)."""
    if x.shape[-1] >= _IM2COL_MIN_T:
        cols = _im2col_cols(x.permute(0, 2, 3, 1), w.shape[-1], time_strides)
        y = cols @ _im2col_weight(w, x.dtype) + b.to(x.dtype)  # (B, N, T_out, 2C)
        y = y.permute(0, 3, 1, 2)
    else:
        y = conv2d_nchw(x, w, b, stride=(1, time_strides))
    return _gate(y, in_channels, dim=1)


def gtu_bnct(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    in_channels: int,
    time_strides: int = 1,
) -> torch.Tensor:
    """GTU in (B, N, C, T) space: the same im2col matmul as :func:`gtu`
    without the (B, C, N, T) round trip. Returns (B, N, T_out, C)."""
    cols = _im2col_cols(x.transpose(2, 3), w.shape[-1], time_strides)
    y = cols @ _im2col_weight(w, x.dtype) + b.to(x.dtype)  # (B, N, T_out, 2C)
    return _gate(y, in_channels, dim=-1)
