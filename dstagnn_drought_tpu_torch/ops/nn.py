"""Small neural-net primitives (counterpart of ``dstagnn_drought_tpu/ops/nn.py``)."""
from __future__ import annotations

import math

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (``nn.LayerNorm`` semantics, eps=1e-5).

    Statistics are computed in float32 whatever the input dtype, and the
    result is cast back to it, as in the JAX package.
    """
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            deterministic: bool, whole=None) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) at train), drawn from ``generator``.
    ``whole`` = (shape, part): x is the part of a tensor of ``shape`` that
    ``part`` cuts from it; the mask is drawn at the whole shape, as one
    device draws it, and x's part of it kept."""
    if deterministic or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape, part = (x.shape, None) if whole is None else whole
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if part is not None:
        mask = part(mask)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def per_sample_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                         beta: float = 1.0, node_rows=None) -> torch.Tensor:
    """Per-sample Huber (SmoothL1) loss: (B,) means over each sample.
    ``node_rows`` = (held, n): pred and target hold one rank's rows of the
    node axis (axis 1), the first ``held`` of them true, of a whole axis of
    ``n`` true rows; a sample's value is then this rank's share of its mean
    (the sum over the held rows over the whole count), and the ranks'
    shares add up to the mean."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if node_rows is None:
        return loss.reshape(loss.shape[0], -1).mean(dim=1)
    held, n = node_rows
    rows = loss[:, :held]
    return rows.reshape(loss.shape[0], -1).sum(dim=1) / (n * math.prod(loss.shape[2:]))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0,
                   sample_weights: torch.Tensor | None = None,
                   weight_total: torch.Tensor | None = None,
                   node_rows=None) -> torch.Tensor:
    """``nn.SmoothL1Loss`` (mean reduction, beta=1), the training criterion.

    ``sample_weights`` (B,) masks the padded tail rows of the batch plan out
    of the reduction; with all-ones weights this is the plain mean. The
    weighted sum is divided by ``weight_total`` (default: the weights' sum):
    a data rank's rows divided by the global batch's total give losses that
    add up to the whole batch's. ``node_rows`` as :func:`per_sample_smooth_l1`:
    a graph rank's share, the shares adding up to the whole loss.
    """
    if sample_weights is None and node_rows is None:
        diff = torch.abs(pred - target)
        return torch.where(diff < beta, 0.5 * diff * diff / beta,
                           diff - 0.5 * beta).mean()
    per_sample = per_sample_smooth_l1(pred, target, beta, node_rows)
    w = (torch.ones_like(per_sample) if sample_weights is None
         else sample_weights.to(per_sample.dtype))
    total = w.sum() if weight_total is None else weight_total.to(per_sample.dtype)
    return (per_sample * w).sum() / torch.clamp(total, min=1.0)
