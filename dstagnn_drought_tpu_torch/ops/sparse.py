"""Sparse (ELL) spatial attention and Chebyshev aggregation — the edge-list
scaling path.

Counterpart of ``dstagnn_drought_tpu/ops/sparse.py``. For each target node
j the graph keeps up to E source neighbours ``indices[j, e]`` with a
validity ``mask`` (padding slots point at j itself), so the spatial path
costs O(N·E) instead of O(N²):

  * the SDDMM computes Q·K only at graph edges;
  * the softmax runs over each target's valid source edges (padding slots
    get -1e30 first), the semantics of a dense computation whose non-edges
    are masked before the softmax (:func:`dense_reference_masked`);
  * the elementwise Chebyshev recurrence keeps the graph's pattern plus the
    diagonal, so gathering T_k at the edges is exact.

The structure is built on the host with numpy (bit-identical to the JAX
package's ``ell_from_adjacency``); :meth:`EllGraph.to` moves its tensors to
a device. The JAX package has no kernel on this path (it was decided
kernel-free), so everything here is PyTorch ops. The aggregation takes one
of two branches by
the size of the one-shot source gather (:data:`_GATHER_BYTES_LIMIT`): below
it, x is gathered once as (B, N, E, C·T) and autograd keeps that gather for
the backward; above it, a loop over edge slots whose backward gathers the
slots again, so autograd keeps only x and the edge weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dstagnn_drought_tpu_torch.ops.attention import _sqrt

_NEG = -1e30


@dataclasses.dataclass
class EllGraph:
    """Static-shape edge list: for target j, sources ``indices[j, :deg(j)]``.

    ``indices`` (N, E) int32 (padding slots hold j) and ``mask`` (N, E) bool
    are numpy arrays; ``tensors`` holds them as torch tensors (``indices`` as
    int64, the index type of ``torch.gather``), on the CPU until :meth:`to`
    moves them."""

    indices: np.ndarray
    mask: np.ndarray
    tensors: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.tensors:
            self.tensors = {
                "indices": torch.from_numpy(self.indices.astype(np.int64)),
                "mask": torch.from_numpy(np.ascontiguousarray(self.mask)),
            }

    def to(self, device) -> "EllGraph":
        """The same graph with its tensors on ``device``."""
        return dataclasses.replace(
            self, tensors={k: v.to(device) for k, v in self.tensors.items()})

    @property
    def num_nodes(self) -> int:
        return self.indices.shape[0]

    @property
    def max_degree(self) -> int:
        return self.indices.shape[1]

    @property
    def num_edges(self) -> int:
        return int(self.mask.sum())


def ell_from_adjacency(
    adj: np.ndarray, max_degree: int | None = None, include_self: bool = True
) -> EllGraph:
    """Dense 0/1 adjacency (source i, target j) → ELL over the source axis.

    ``adj[i, j] != 0`` means i is a source of target j, as in the dense
    aggregation out_j = Σ_i A[i, j]·x_i. The diagonal is included by default
    (the Chebyshev stack always carries T_0 = I). ``max_degree`` caps the
    slots; a target with more sources keeps those with the lowest ids."""
    adj = np.asarray(adj)
    N = adj.shape[0]
    A = adj != 0
    if include_self:
        A = A | np.eye(N, dtype=bool)
    deg = A.sum(axis=0)  # in-degree per target j
    E = int(max_degree if max_degree is not None else deg.max())
    indices = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, E))
    mask = np.zeros((N, E), dtype=bool)
    src, tgt = np.nonzero(A)  # sorted by source; re-group by target
    order = np.argsort(tgt, kind="stable")
    src, tgt = src[order], tgt[order]
    pos = np.concatenate([[0], np.cumsum(np.bincount(tgt, minlength=N))])
    for j in range(N):
        s = src[pos[j]:pos[j + 1]][:E]
        indices[j, : len(s)] = s
        mask[j, : len(s)] = True
    return EllGraph(indices, mask)


def gather_edge_values(dense: torch.Tensor, ell: EllGraph) -> torch.Tensor:
    """(..., N, N) dense (source, target) matrix → (..., N, E) values at
    (indices[j, e], j). A plane smaller than the graph's node count is
    zero-padded to it first (the padding targets are masked downstream)."""
    n = ell.num_nodes
    pad_rows, pad_cols = n - dense.shape[-2], n - dense.shape[-1]
    if pad_rows or pad_cols:
        dense = torch.nn.functional.pad(dense, (0, pad_cols, 0, pad_rows))
    # dense[..., i, j] with i = indices[j, e]  ≡  denseᵀ[..., j, i]
    d_t = dense.transpose(-1, -2)
    idx = ell.tensors["indices"].expand(*d_t.shape[:-1], ell.max_degree)
    return torch.gather(d_t, -1, idx)


def sparse_spatial_attention_scores(
    x: torch.Tensor,
    ell: EllGraph,
    *,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """SDDMM: x (B, N, d_model) → raw edge scores (B, K, N, E),
    score[b,h,j,e] = Q[b, src, h]·K[b, j, h]/√d_k with src = indices[j,e]."""
    B, N, _ = x.shape
    q = (x @ wq).reshape(B, N, n_heads, d_k)
    k = (x @ wk).reshape(B, N, n_heads, d_k)
    q_src = q[:, ell.tensors["indices"]]  # (B, N, E, H, d_k)
    return torch.einsum("bjehd,bjhd->bhje", q_src, k) / _sqrt(d_k, x)


# One-shot source gathers above this size take the loop over edge slots
# (the JAX package's limit: the gather is multi-GB at GAMBIA scale)
_GATHER_BYTES_LIMIT = 256 * 2**20


def edge_gather_bytes(xm: torch.Tensor, ell: EllGraph) -> int:
    """Bytes of the one-shot (B, N, E, C·T) source gather of xm (B, N, C·T)."""
    B, N, M = xm.shape
    return B * N * ell.max_degree * M * xm.element_size()


def _gather_aggregate(A: torch.Tensor, xm: torch.Tensor, ell: EllGraph) -> torch.Tensor:
    """agg[b,k,j] = Σ_e A[b,k,j,e]·xm[b, indices[j,e]] through one gather."""
    x_src = xm[:, ell.tensors["indices"]]  # (B, N, E, C·T)
    return torch.einsum("bkje,bjem->bkjm", A, x_src)


class _SlotLoopAggregate(torch.autograd.Function):
    """The same sum as :func:`_gather_aggregate`, one edge slot at a time,
    accumulated in the activation dtype; the backward gathers each slot
    again instead of keeping E gathered copies of x."""

    @staticmethod
    def forward(ctx, A, xm, indices):
        B, K, N, E = A.shape
        agg = xm.new_zeros((B, K, N, xm.shape[-1]))
        for e in range(E):
            agg = agg + A[..., e, None] * xm[:, None, indices[:, e]]
        ctx.save_for_backward(A, xm, indices)
        return agg

    @staticmethod
    def backward(ctx, g):
        A, xm, indices = ctx.saved_tensors
        dA = torch.empty_like(A) if ctx.needs_input_grad[0] else None
        dxm = torch.zeros_like(xm) if ctx.needs_input_grad[1] else None
        for e in range(A.shape[-1]):
            idx = indices[:, e]
            if dA is not None:
                dA[..., e] = torch.einsum("bkjm,bjm->bkj", g, xm[:, idx])
            if dxm is not None:
                dxm.index_add_(1, idx, torch.einsum("bkj,bkjm->bjm", A[..., e], g))
        return dA, dxm, None


def _slot_loop_aggregate(A: torch.Tensor, xm: torch.Tensor, ell: EllGraph) -> torch.Tensor:
    """The sum of :func:`_gather_aggregate` by :class:`_SlotLoopAggregate`."""
    return _SlotLoopAggregate.apply(A, xm, ell.tensors["indices"])


def sparse_cheb_conv_with_sat(
    x: torch.Tensor,
    edge_scores: torch.Tensor,
    ell: EllGraph,
    *,
    cheb_edges: torch.Tensor,
    bias_edges: torch.Tensor,
    thetas: torch.Tensor,
) -> torch.Tensor:
    """Sparse attention-modulated Chebyshev conv.

    x (B, N, C, T); edge_scores (B, K, N, E) raw SDDMM scores; cheb_edges
    and bias_edges (K, N, E), T_k and adj_pa ⊙ mask_k gathered at the edges
    (:func:`gather_edge_values`); thetas (K, C, C_out) → (B, N, C_out, T),
    ReLU applied. The softmax runs over each target's valid source edges."""
    B, N, C, T = x.shape
    mask = ell.tensors["mask"]
    s = edge_scores + bias_edges[None]
    s = torch.where(mask[None, None], s, _NEG)
    att = torch.softmax(s, dim=-1)  # over source edges e
    A = cheb_edges[None] * att * mask[None, None]
    xm = x.reshape(B, N, C * T)
    if edge_gather_bytes(xm, ell) > _GATHER_BYTES_LIMIT:
        agg = _slot_loop_aggregate(A, xm, ell)
    else:
        agg = _gather_aggregate(A, xm, ell)
    agg = agg.reshape(B, A.shape[1], N, C, T)
    return torch.relu(torch.einsum("bkjct,kco->bjot", agg, thetas))


def dense_reference_masked(
    x: torch.Tensor,
    scores: torch.Tensor,
    adj_pattern: torch.Tensor,
    *,
    cheb_polys: torch.Tensor,
    bias: torch.Tensor,
    thetas: torch.Tensor,
) -> torch.Tensor:
    """Dense masked-softmax equivalent of the sparse path (test oracle):
    non-edges get -1e30 before the softmax instead of relying on T_k's
    zeros."""
    B, N, C, T = x.shape
    pattern = (adj_pattern != 0) | torch.eye(N, dtype=torch.bool, device=x.device)
    s = scores + bias[None]
    s = torch.where(pattern[None, None], s, _NEG)
    att = torch.softmax(s, dim=2)
    A = cheb_polys[None] * att * pattern[None, None]
    xm = x.reshape(B, N, C * T)
    agg = torch.einsum("bkij,bim->bkjm", A, xm).reshape(B, A.shape[1], N, C, T)
    return torch.relu(torch.einsum("bkjct,kco->bjot", agg, thetas))
