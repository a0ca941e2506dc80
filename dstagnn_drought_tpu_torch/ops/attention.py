"""Attention primitives of the DSTAGNN family.

Counterpart of ``dstagnn_drought_tpu/ops/attention.py``, with the same
layouts at the public functions:

  * ``temporal_attention`` — multi-head attention over time whose token
    width is the node count N. The raw pre-softmax scores (plus the previous
    block's scores) are returned for the next block. Reference quirk kept:
    the softmax runs over the **query** axis (axis 3 of (B, F, H, T_q, T_k))
    while the value contraction sums over the key axis.
  * ``spatial_attention_scores`` — raw (B, K, N, N) score maps, one head per
    Chebyshev order, no softmax (that happens in the Chebyshev conv, over
    the source axis).
"""
from __future__ import annotations

import torch

from dstagnn_drought_tpu_torch.ops.nn import layer_norm


def _sqrt(d: int, like: torch.Tensor) -> torch.Tensor:
    # sqrt(d) in the activation dtype, like jnp.sqrt(jnp.asarray(d, dtype));
    # filled on the device (a host copy is refused under CUDA-graph capture)
    return torch.full((), float(d), dtype=like.dtype, device=like.device).sqrt()


def temporal_attention(
    x: torch.Tensor,
    res_att,
    *,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    n_heads: int,
    d_k: int,
    d_v: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, F, T, N); res_att: (B, F, H, T, T) or a scalar.
    wq/wk: (N, H·d_k), wv: (N, H·d_v), wo: (H·d_v, N).

    Returns (out (B, F, T, N), scores (B, F, H, T, T) raw)."""
    B, F, T, N = x.shape
    qkv = x @ torch.cat([wq, wk, wv], dim=1)
    hk = n_heads * d_k
    q = qkv[..., :hk].reshape(B, F, T, n_heads, d_k)
    k = qkv[..., hk:2 * hk].reshape(B, F, T, n_heads, d_k)
    v = qkv[..., 2 * hk:].reshape(B, F, T, n_heads, d_v)
    scores = torch.einsum("bfqhd,bfkhd->bfhqk", q, k) / _sqrt(d_k, x)
    scores = scores + res_att
    attn = torch.softmax(scores, dim=3)  # the query axis (reference quirk)
    context = torch.einsum("bfhqk,bfkhd->bfqhd", attn, v).reshape(
        B, F, T, n_heads * d_v
    )
    out = context @ wo
    out = layer_norm(out + x, ln_scale, ln_bias)
    return out, scores


def spatial_attention_scores(
    x: torch.Tensor,
    *,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """x: (B, N, d_model); wq/wk: (d_model, K·d_k) → raw scores (B, K, N, N)."""
    B, N, _ = x.shape
    qk = x @ torch.cat([wq, wk], dim=1)
    q = qk[..., : n_heads * d_k].reshape(B, N, n_heads, d_k)
    k = qk[..., n_heads * d_k:].reshape(B, N, n_heads, d_k)
    return torch.einsum("bihd,bjhd->bhij", q, k) / _sqrt(d_k, x)
