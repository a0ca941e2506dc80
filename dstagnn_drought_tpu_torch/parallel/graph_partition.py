"""Node-partitioned sparse (ELL) spatial conv over the 'graph' axis.

Counterpart of ``dstagnn_drought_tpu/parallel/graph_partition.py``. Each
graph rank owns a contiguous block of ``nloc`` *target* nodes; aggregation
needs *source* features that may live on other ranks, the halo. Two
strategies, as in JAX:

* **Full gather** (:func:`partitioned_sparse_conv`): one all-gather of the
  (B, nloc, ·) rows of every rank, then the local SDDMM → masked softmax →
  ELL aggregation for the rank's targets.
* **Targeted halo** (:func:`halo_partitioned_sparse_conv`): the host-side
  :func:`build_halo_plan` finds, for every (sender, receiver) pair, the
  boundary rows the receiver's edges reference; at step time each rank
  packs only those rows (source Q-projections and source features in one
  payload) and one all-to-all delivers them. ELL indices are remapped
  ahead into the ``[own rows ‖ halo slots]`` buffer, so the aggregation is
  local code.

The targeted-halo conv, the one the Trainer wires, takes and returns this
rank's node rows (JAX's ``out_specs = node_sharded2``); the full-gather
conv takes whole activations (the same on every rank of the data row),
takes the rank's rows on entry and all-gathers its output on the way out
(:mod:`~dstagnn_drought_tpu_torch.parallel.comm`). The exchanges move what
JAX's ``shard_map`` moves. There is no kernel on this
path: JAX has none for ELL, and the aggregation is the tensor ops of
``ops/sparse.py``'s gather branch. The plans are numpy, equal to JAX's
field by field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dstagnn_drought_tpu_torch.ops.attention import _sqrt
from dstagnn_drought_tpu_torch.ops.sparse import EllGraph
from dstagnn_drought_tpu_torch.parallel import comm

_NEG = -1e30


def pad_nodes_for_mesh(n: int, graph_axis: int) -> int:
    """Targets split evenly over 'graph': pad with isolated dummy nodes."""
    return -(-n // graph_axis) * graph_axis


def shard_ell(ell: EllGraph, graph_axis: int) -> EllGraph:
    """An ELL graph padded so its target axis splits evenly over the mesh
    (padding targets point at themselves, with all-False masks)."""
    n = ell.num_nodes
    n_pad = pad_nodes_for_mesh(n, graph_axis)
    if n_pad == n:
        return ell
    extra = n_pad - n
    pad_idx = np.tile(np.arange(n, n_pad, dtype=ell.indices.dtype)[:, None],
                      (1, ell.max_degree))
    indices = np.concatenate([ell.indices, pad_idx], axis=0)
    mask = np.concatenate([ell.mask, np.zeros((extra, ell.max_degree), bool)], axis=0)
    return EllGraph(indices, mask)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static exchange schedule for one ELL graph over P node shards."""

    local_indices: np.ndarray  # (P, nloc, E) int32 → [own ‖ halo] buffer ids
    mask: np.ndarray           # (P, nloc, E) bool — valid edges
    send_idx: np.ndarray       # (P, P, H) int32 — send_idx[s, r]: rows (local
                               #   to sender s's block) s ships to receiver r
    num_shards: int
    nloc: int
    halo_width: int            # H — max rows any pair exchanges (padded)

    @property
    def buffer_rows(self) -> int:
        """Rows in each rank's local source buffer: own block + P halo slots."""
        return self.nloc + self.num_shards * self.halo_width


def build_halo_plan(ell: EllGraph, num_shards: int, *, pad_to: int = 8) -> HaloPlan:
    """The boundary-row exchange for a target-partitioned ELL graph: for
    each pair (s → r) the unique source rows in s's block that r's edges
    reference, the per-pair count padded to a common width H (a multiple of
    ``pad_to``), and r's ELL indices remapped into its buffer ``[own nloc
    rows ‖ s0 halo ‖ s1 halo ‖ …]``. Masked edges keep an arbitrary
    in-range id."""
    idx = np.asarray(ell.indices)
    msk = np.asarray(ell.mask)
    N, E = idx.shape
    P_ = num_shards
    if N % P_:
        raise ValueError(f"N={N} must divide over {P_} shards; use shard_ell first")
    nloc = N // P_

    rows_needed = [[None] * P_ for _ in range(P_)]
    h_max = 0
    for r in range(P_):
        src = idx[r * nloc:(r + 1) * nloc][msk[r * nloc:(r + 1) * nloc]]
        blk = src // nloc
        for s in range(P_):
            if s == r:
                continue
            sel = np.unique(src[blk == s])
            rows_needed[r][s] = sel
            h_max = max(h_max, len(sel))
    H = max(-(-h_max // pad_to) * pad_to, pad_to)

    send_idx = np.zeros((P_, P_, H), np.int32)
    local_indices = np.zeros((P_, nloc, E), np.int32)
    for r in range(P_):
        remap = np.zeros(N, np.int32)
        remap[r * nloc:(r + 1) * nloc] = np.arange(nloc, dtype=np.int32)
        for s in range(P_):
            if s == r:
                continue
            sel = rows_needed[r][s]
            send_idx[s, r, : len(sel)] = sel - s * nloc
            remap[sel] = nloc + s * H + np.arange(len(sel), dtype=np.int32)
        local_indices[r] = remap[idx[r * nloc:(r + 1) * nloc]]

    return HaloPlan(local_indices=local_indices, mask=msk.reshape(P_, nloc, E),
                    send_idx=send_idx, num_shards=P_, nloc=nloc, halo_width=H)


def halo_stats(plan: HaloPlan) -> dict:
    """Comm accounting: halo rows moved (the padded schedule, what the wire
    carries) against the all-gather volume."""
    N = plan.nloc * plan.num_shards
    rows_sent = plan.halo_width * (plan.num_shards - 1)
    gather_rows = N - plan.nloc
    return {
        "halo_rows_per_device": rows_sent,
        "all_gather_rows_per_device": gather_rows,
        "volume_ratio": rows_sent / max(gather_rows, 1),
        "halo_width": plan.halo_width,
    }


def pad_nodes(a: torch.Tensor, axis: int, n_pad: int) -> torch.Tensor:
    """Zero-pad ``a``'s node axis ``axis`` up to ``n_pad``."""
    extra = n_pad - a.shape[axis]
    if extra == 0:
        return a
    shape = list(a.shape)
    shape[axis] = extra
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _aggregate(q_src, k_loc, bias_l, cheb_l, msk, x_src, thetas, d_k, C, T):
    """The local softmax over source edges, aggregation and Θ mix:
    q_src (B, nloc, E, K, d_k), k_loc (B, nloc, K, d_k), edge planes
    (K, nloc, E), x_src (B, nloc, E, C·T) → relu output (B, nloc, Co, T)."""
    B, nloc = k_loc.shape[:2]
    s = torch.einsum("bjehd,bjhd->bhje", q_src, k_loc) / _sqrt(d_k, k_loc)
    s = s + bias_l[None]
    s = torch.where(msk[None, None], s, torch.tensor(_NEG, dtype=s.dtype, device=s.device))
    att = torch.softmax(s, dim=-1)
    A = cheb_l[None] * att * msk[None, None]
    agg = torch.einsum("bkje,bjem->bkjm", A, x_src).reshape(B, A.shape[1], nloc, C, T)
    return torch.relu(torch.einsum("bkjct,kco->bjot", agg, thetas))


def halo_partitioned_sparse_conv(
    mesh,
    emb: torch.Tensor,
    x: torch.Tensor,
    plan: HaloPlan,
    *,
    cheb_edges: torch.Tensor,
    bias_edges: torch.Tensor,
    thetas: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """The ELL conv with the targeted halo: emb (B, nloc, d_model) and x
    (B, nloc, C, T), this rank's rows of the node axis padded to the plan's
    ``nloc·P`` (the plan of a :func:`shard_ell`-padded graph, whose padding
    targets aggregate nothing), and the edge planes (K, N_e, E) whole →
    (B, nloc, Co, T), this rank's rows. The payload a rank sends is (B, P,
    H, K·d_k + C·T)."""
    B, nloc, C, T = x.shape
    n_pad = plan.nloc * plan.num_shards
    grp, r = mesh.graph_group, mesh.g
    hq = n_heads * d_k
    cheb_l = comm.enter(pad_nodes(cheb_edges, 1, n_pad), 1, grp)
    bias_l = comm.enter(pad_nodes(bias_edges, 1, n_pad), 1, grp)
    thetas, wq, wk = (comm.copy_to(w, grp) for w in (thetas, wq, wk))
    dev = x.device
    lidx = torch.from_numpy(plan.local_indices[r].astype(np.int64)).to(dev)
    msk = torch.from_numpy(plan.mask[r]).to(dev)
    send_idx = torch.from_numpy(plan.send_idx[r].astype(np.int64)).to(dev)
    # 1) the payload: [Q-projection of my rows ‖ my features]
    q_own = (emb @ wq).to(x.dtype)
    payload = torch.cat([q_own, x.reshape(B, nloc, C * T)], dim=-1)
    send = payload[:, send_idx].transpose(0, 1)             # (P, B, H, D)
    # 2) the halo: one all-to-all delivers each receiver its boundary rows
    recv = comm.exchange(send.contiguous(), grp).transpose(0, 1)
    # 3) [own ‖ halo] buffer, the per-edge sources
    k_loc = (emb @ wk).reshape(B, nloc, n_heads, d_k)
    buf = torch.cat([payload, recv.reshape(B, -1, payload.shape[-1])], dim=1)
    q_src = buf[:, lidx, :hq].reshape(B, nloc, -1, n_heads, d_k)
    return _aggregate(q_src, k_loc, bias_l, cheb_l, msk, buf[:, lidx, hq:], thetas, d_k, C, T)


def partitioned_sparse_conv(
    mesh,
    emb: torch.Tensor,
    x: torch.Tensor,
    ell: EllGraph,
    *,
    cheb_edges: torch.Tensor,
    bias_edges: torch.Tensor,
    thetas: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """The ELL conv with the full gather: every rank all-gathers the rows
    of emb and x, then aggregates for its own targets (global source ids).
    N must divide over the 'graph' axis (:func:`shard_ell`), as in JAX."""
    B, N, C, T = x.shape
    grp, r = mesh.graph_group, mesh.g
    nloc = N // mesh.graph
    if nloc * mesh.graph != N:
        raise ValueError(f"N={N} must divide over {mesh.graph} shards; use shard_ell first")
    emb_l = comm.enter(emb, 1, grp)
    x_l = comm.enter(x.reshape(B, N, C * T), 1, grp)
    cheb_l = comm.enter(cheb_edges, 1, grp)
    bias_l = comm.enter(bias_edges, 1, grp)
    thetas, wq, wk = (comm.copy_to(w, grp) for w in (thetas, wq, wk))
    # 1) the halo: every rank's rows
    emb_full = comm.gather_rows(emb_l, 1, grp)
    x_full = comm.gather_rows(x_l, 1, grp)
    rows = slice(r * nloc, (r + 1) * nloc)
    idx = ell.tensors["indices"][rows].to(x.device)
    msk = ell.tensors["mask"][rows].to(x.device)
    # 2) the SDDMM for this rank's targets, 3) softmax and aggregation
    q = (emb_full @ wq).reshape(B, N, n_heads, d_k)
    k = (emb_l @ wk).reshape(B, nloc, n_heads, d_k)
    out = _aggregate(q[:, idx], k, bias_l, cheb_l, msk, x_full[:, idx], thetas, d_k, C, T)
    return comm.leave(out, 1, grp)
