"""K-order Chebyshev graph convolutions (plain tensor ops).

Counterpart of ``dstagnn_drought_tpu/ops/cheb.py``: the attention-modulated
conv is the path the DSTAGNN model runs when ``use_pallas`` is false;
:func:`cheb_conv` is the plain conv of the ASTGCN/MSTGCN and STGCN families. The hand-written kernel for the same
aggregation lives in ``ops/cuda/cheb_sat.py``. Semantics:
  * per-order bias ``STAt[:,k] + adj_pa ⊙ mask_k``;
  * softmax over the **source-node axis** i (dim 2 of (B, K, N, N));
  * aggregation through the transpose: out_j = Σ_i (T_k ⊙ att)[i,j] · x_i;
  * Θ mix, sum over orders k, ReLU.
"""
from __future__ import annotations

import torch


def cheb_attention_matrix(
    spatial_attention: torch.Tensor,
    adj_pa: torch.Tensor,
    cheb_polys: torch.Tensor,
    masks: torch.Tensor,
) -> torch.Tensor:
    """A[b,k,i,j] = T_k[i,j]·softmax_i(S[b,k] + adj_pa ⊙ mask_k)[i,j]."""
    bias = adj_pa[None, :, :] * masks  # (K, N, N)
    att = torch.softmax(spatial_attention + bias[None], dim=2)
    return cheb_polys[None] * att


def cheb_conv_with_sat(
    x: torch.Tensor,
    spatial_attention: torch.Tensor,
    adj_pa: torch.Tensor,
    *,
    cheb_polys: torch.Tensor,
    masks: torch.Tensor,
    thetas: torch.Tensor,
) -> torch.Tensor:
    """x: (B, N, C_in, T); S: (B, K, N, N); adj_pa: (N, N); cheb_polys and
    masks: (K, N, N); thetas: (K, C_in, C_out) → (B, N, C_out, T), ReLU."""
    B, N, C, T = x.shape
    A = cheb_attention_matrix(spatial_attention, adj_pa, cheb_polys, masks)
    agg = torch.einsum("bkij,bim->bkjm", A, x.reshape(B, N, C * T))
    agg = agg.reshape(B, A.shape[1], N, C, T)
    return torch.relu(torch.einsum("bkjct,kco->bjot", agg, thetas))


def cheb_conv(x: torch.Tensor, *, cheb_polys: torch.Tensor,
              thetas: torch.Tensor) -> torch.Tensor:
    """Plain K-order Chebyshev conv: x (B, N, C_in, T), cheb_polys (K, N, N),
    thetas (K, C_in, C_out) → ReLU(Σ_k (T_kᵀ x) Θ_k), (B, N, C_out, T)."""
    B, N, C, T = x.shape
    agg = torch.einsum("kij,bim->bkjm", cheb_polys, x.reshape(B, N, C * T))
    agg = agg.reshape(B, cheb_polys.shape[0], N, C, T)
    return torch.relu(torch.einsum("bkjct,kco->bjot", agg, thetas))
