"""Node-partitioned block-sparse (BELL) spatial conv over the 'graph' axis,
with the fused BELL kernels launched on each rank's own tiles.

Counterpart of ``dstagnn_drought_tpu/parallel/bell_partition.py``. The
partitioning unit is the *target tile*: graph rank g owns a contiguous
range of target tiles (128-row output blocks at BS = 128) and runs F, the
fused forward kernel, and K1 and K2, its backward kernels
(``ops/cuda/bell_fused.py``, ``ops/cuda/bell_bwd.py``), on its own tile
list. Three paths, as in JAX:

* :class:`BellShardPlan` / :func:`partitioned_bell_conv` — dense (K, N, N)
  masks: one all-gather of every rank's source rows (q and x), then F on
  the rank's target tiles against the global source ids.
* :class:`BellTileShardPlan` / :func:`partitioned_bell_tiles_conv` —
  tile-resident masks, each rank holding its (A_loc, K, BS, BS) slice, and
  a **targeted block halo**: one all-to-all per operand (x, q) fills the
  rank's *compact* table of the ``ns_true[g]`` source blocks it references,
  built from the static routing tables ``send_idx``/``recv_map``; every id
  of the rank's tile list is a compact id.
* :class:`BellTileOverlapLists` / :func:`partitioned_bell_tiles_conv_overlap`
  — the same, each rank's tiles split into sublist A (every source block
  local: F reads the rank's own rows and is launched while the exchange is
  in flight) and sublist B (some source remote: F reads the compact
  table once the exchange is waited on); ``inv_pos`` reassembles them.

The kernels take one row count for sources and targets (their batch
stride), so a rank's source table and its target rows are both padded to
``R = max(source blocks, target tiles)`` blocks, the extra target tiles
with no active entry (their output is zero and cut away), and
``ops/cuda/bell_fused.BellTilesOut`` runs on a per-rank structure
(:class:`RankTiles`). A rank launches its tile list's true entries; the
active-list tail that pads ``A_loc`` is never visited, so its mask entries
get no gradient, as in JAX. Pad tiles (one PAD entry of zero pattern and
zero Chebyshev value) contribute exactly zero to the output and to every
gradient; a tile whose scores are all masked to −1e30 gives a uniform
softmax, not a NaN.

The plans are numpy, built on the host, equal to JAX's field by field.
Each conv takes and returns this rank's node rows (JAX's ``out_specs =
node_sh``): emb, x and the output hold rows ``[g·Np/P, (g+1)·Np/P)`` of the
node axis padded to the plan's grid, the padding rows of emb and x zero.
The constant planes enter whole and the conv takes the rank's part of them
(:mod:`~dstagnn_drought_tpu_torch.parallel.comm`); Θ, wq and wk are whole
and their gradients are summed over the group.
The port's kernels have one c-major feature layout, so JAX's t/c choice of
the tile path (``layout``, ``_tiles_use_c_layout``) has no counterpart: both
of JAX's layouts compute the function the port computes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dstagnn_drought_tpu_torch.ops.block_sparse import BlockEllGraph, active_tile_values
from dstagnn_drought_tpu_torch.ops.cuda.bell_fused import BellTilesOut
from dstagnn_drought_tpu_torch.parallel import comm
from dstagnn_drought_tpu_torch.parallel.graph_partition import pad_nodes

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class BellShardPlan:
    """Per-shard BELL tile lists, stacked on a leading shard axis."""

    block_idx: np.ndarray   # (P, NJ_loc, S) int32 — global source block ids
    pattern: np.ndarray     # (P, NJ_loc, S, BS, BS) f32 edge patterns
    a_src: np.ndarray       # (P, A_loc) int32 — global source block ids
    a_tgt: np.ndarray       # (P, A_loc) int32 — LOCAL target tile ids
    tile_start: np.ndarray  # (P, NJ_loc) int32 — offsets into the local list
    tile_count: np.ndarray  # (P, NJ_loc) int32
    adj_bool: np.ndarray    # (Np, Np) bool — padded global edge pattern
    n_nodes: int            # true node count N
    block_size: int
    num_shards: int

    @property
    def padded_nodes(self) -> int:
        return self.block_idx.shape[0] * self.block_idx.shape[1] * \
            self.block_size

    @property
    def tiles_per_shard(self) -> int:
        return self.block_idx.shape[1]


def build_bell_shard_plan(
    bell: BlockEllGraph, num_shards: int
) -> BellShardPlan:
    """Split a BlockEllGraph's target tiles across ``num_shards`` devices.

    The tile count is padded to a shard multiple with inert tiles (one
    all-False-pattern self slot: softmax output there is finite garbage that
    the caller slices away; gradients through it are exactly zero because
    the modulated weights are pattern-masked). Per-shard active lists are
    padded to a common length with entries past every tile's window.
    """
    if bell.active_src is None or bell.tile_start is None:
        raise ValueError("build_bell_shard_plan needs the active-tile list; "
                         "build the graph with block_ell_from_adjacency().")
    P_ = num_shards
    NJ = bell.num_tiles
    S = bell.max_blocks
    BS = bell.block_size
    NJ_pad = -(-NJ // P_) * P_
    NJ_loc = NJ_pad // P_

    block_idx = np.zeros((NJ_pad, S), np.int32)
    pattern = np.zeros((NJ_pad, S, BS, BS), np.float32)
    counts = np.zeros(NJ_pad, np.int32)
    block_idx[:NJ] = np.asarray(bell.block_idx)
    valid = np.asarray(bell.pattern) & np.asarray(
        bell.block_mask)[:, :, None, None]
    pattern[:NJ] = valid.astype(np.float32)
    counts[:NJ] = np.asarray(bell.tile_count)
    # inert pad tiles: one self slot, empty pattern
    for j in range(NJ, NJ_pad):
        block_idx[j, 0] = j
        counts[j] = 1

    # global active list (pad tiles appended in target order)
    a_src_g = list(np.asarray(bell.active_src))
    a_tgt_g = list(np.asarray(bell.active_tgt))
    for j in range(NJ, NJ_pad):
        a_src_g.append(j)
        a_tgt_g.append(j)
    a_src_g = np.asarray(a_src_g, np.int32)
    a_tgt_g = np.asarray(a_tgt_g, np.int32)
    starts_g = np.r_[0, np.cumsum(counts)[:-1]].astype(np.int32)

    A_loc = int(max(
        counts[r * NJ_loc:(r + 1) * NJ_loc].sum() for r in range(P_)
    ))
    A_loc = max(A_loc, 1)
    a_src = np.zeros((P_, A_loc), np.int32)
    a_tgt = np.zeros((P_, A_loc), np.int32)
    tile_start = np.zeros((P_, NJ_loc), np.int32)
    tile_count = np.zeros((P_, NJ_loc), np.int32)
    for r in range(P_):
        lo_tile = r * NJ_loc
        lo = starts_g[lo_tile]
        hi = lo + counts[lo_tile:lo_tile + NJ_loc].sum()
        seg = slice(lo, hi)
        n_seg = hi - lo
        a_src[r, :n_seg] = a_src_g[seg]
        a_tgt[r, :n_seg] = a_tgt_g[seg] - lo_tile
        tile_start[r] = starts_g[lo_tile:lo_tile + NJ_loc] - lo
        tile_count[r] = counts[lo_tile:lo_tile + NJ_loc]

    Np = NJ_pad * BS
    adj_bool = np.zeros((Np, Np), bool)
    ab = np.asarray(bell.adj_bool)
    adj_bool[: ab.shape[0], : ab.shape[1]] = ab
    return BellShardPlan(
        block_idx=block_idx.reshape(P_, NJ_loc, S),
        pattern=pattern.reshape(P_, NJ_loc, S, BS, BS),
        a_src=a_src, a_tgt=a_tgt,
        tile_start=tile_start, tile_count=tile_count,
        adj_bool=adj_bool, n_nodes=bell.n_nodes,
        block_size=BS, num_shards=P_,
    )


@dataclasses.dataclass(frozen=True)
class BellTileShardPlan:
    """Per-shard BELL structure for the tile-resident partitioned path.

    Source blocks are referenced through a per-shard COMPACT table: shard r
    sees only the ``ns_true[r]`` source blocks it actually references
    (padded to ``ns_max``); the routing tables ``send_idx``/``recv_map``
    drive one targeted ``all_to_all`` that fills the table. Every id in
    ``block_idx``/``a_src`` is a compact id. All arrays carry a leading
    shard axis; graph rank g reads row g.
    """

    # per-shard tile lists (compact source ids)
    block_idx: np.ndarray    # (P, NJ_loc, S) int32
    pattern: np.ndarray      # (P, NJ_loc, S, BS, BS) f32
    tile_start: np.ndarray   # (P, NJ_loc) int32
    tile_count: np.ndarray   # (P, NJ_loc) int32
    a_src: np.ndarray        # (P, A_loc) int32 compact source tile ids
    a_tgt: np.ndarray        # (P, A_loc) int32 local target tile ids
    active_slot: np.ndarray  # (P, A_loc) int32
    # fused-backward source-sorted view (over compact source tiles)
    src_order: np.ndarray    # (P, A_loc) int32
    src_start: np.ndarray    # (P, NS_max) int32
    src_count: np.ndarray    # (P, NS_max) int32
    # targeted-halo routing
    send_idx: np.ndarray     # (P, P, H_max) int32 — local block ids to send
    recv_map: np.ndarray     # (P, NS_max) int32 — flat (owner·H_max+slot)
    # per-active-entry constants (tile-resident operands)
    pattern_act: np.ndarray  # (P, A_loc, BS, BS) bool
    pa_tiles: np.ndarray     # (P, A_loc, BS, BS) f32
    cheb_tiles: np.ndarray   # (P, A_loc, K, BS, BS) f32
    # static sizes
    n_nodes: int
    block_size: int
    num_shards: int
    ns_max: int              # compact source tiles per shard (padded)
    h_max: int               # exchange slots per (owner, dest) pair
    max_out: int             # max outgoing tiles of any compact source
    ns_true: tuple           # true referenced-block count per shard
    a_true: tuple            # true active-entry count per shard
    seg_lo: tuple            # augmented-global-list offset per shard

    @property
    def tiles_per_shard(self) -> int:
        return self.block_idx.shape[1]

    def pack_active(self, values: np.ndarray, fill=0) -> np.ndarray:
        """(A_global, ...) values in BlockEllGraph active-list order →
        (P, A_loc, ...) per-shard layout (pad-tile entries filled).

        Use to carry single-device tile-resident params/constants (e.g.
        ``mask_tiles``) into the partitioned layout."""
        v = np.asarray(values)
        P_ = self.num_shards
        A_loc = self.max_active
        n_pad_entries = sum(self.a_true) - v.shape[0]
        aug = np.concatenate(
            [v, np.full((n_pad_entries,) + v.shape[1:], fill, v.dtype)]
        )
        out = np.full((P_, A_loc) + v.shape[1:], fill, v.dtype)
        for r in range(P_):
            n = self.a_true[r]
            out[r, :n] = aug[self.seg_lo[r]: self.seg_lo[r] + n]
        return out

    @property
    def max_active(self) -> int:
        return self.a_src.shape[1]

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.tiles_per_shard * self.block_size

    def halo_stats(self) -> dict:
        """Exchange-volume accounting: targeted halo vs all_gather."""
        P_ = self.num_shards
        NJ_loc = self.tiles_per_shard
        referenced = int(sum(self.ns_true))
        remote = 0
        for r in range(P_):
            # recover global ids via recv_map owner index
            owners = self.recv_map[r][: self.ns_true[r]] // self.h_max
            remote += int((owners != r).sum())
        gather_blocks = P_ * P_ * NJ_loc  # all_gather: every shard gets all
        return {
            "num_shards": P_,
            "blocks_total": P_ * NJ_loc,
            "referenced_blocks": referenced,
            "remote_blocks": remote,
            "targeted_exchange_blocks": referenced,
            "all_gather_blocks": gather_blocks,
            "volume_vs_all_gather": referenced / max(gather_blocks, 1),
        }


def build_bell_tile_shard_plan(
    bell: BlockEllGraph, num_shards: int, adj_pa, cheb_polys
) -> BellTileShardPlan:
    """Split a BlockEllGraph across ``num_shards`` with compact per-shard
    source tables, targeted-halo routing, per-shard fused-backward lists,
    and tile-resident constants (adj_pa / Chebyshev values per active tile).
    """
    if bell.active_src is None or bell.tile_start is None:
        raise ValueError("build_bell_tile_shard_plan needs the active-tile "
                         "list (block_ell_from_adjacency).")
    P_ = num_shards
    NJ = bell.num_tiles
    S = bell.max_blocks
    BS = bell.block_size
    K = np.asarray(cheb_polys).shape[0]
    NJ_pad = -(-NJ // P_) * P_
    NJ_loc = NJ_pad // P_

    counts = np.zeros(NJ_pad, np.int32)
    counts[:NJ] = np.asarray(bell.tile_count)
    valid_g = np.asarray(bell.pattern) & np.asarray(
        bell.block_mask)[:, :, None, None]              # (NJ, S, BS, BS)

    # global active list + per-entry constants, pad tiles appended in order
    a_src_g = list(np.asarray(bell.active_src))
    a_tgt_g = list(np.asarray(bell.active_tgt))
    a_slot_g = list(np.asarray(bell.active_slot))
    pat_g = list(valid_g[np.asarray(bell.active_tgt),
                         np.asarray(bell.active_slot)])
    pa_g = list(active_tile_values(np.asarray(adj_pa), bell))
    cheb_g = list(active_tile_values(np.asarray(cheb_polys), bell))
    zero_tile = np.zeros((BS, BS), np.float32)
    zero_cheb = np.zeros((K, BS, BS), np.float32)
    for j in range(NJ, NJ_pad):
        a_src_g.append(j)
        a_tgt_g.append(j)
        a_slot_g.append(0)
        pat_g.append(np.zeros((BS, BS), bool))
        pa_g.append(zero_tile)
        cheb_g.append(zero_cheb)
        counts[j] = 1
    a_src_g = np.asarray(a_src_g, np.int32)
    a_tgt_g = np.asarray(a_tgt_g, np.int32)
    a_slot_g = np.asarray(a_slot_g, np.int32)
    starts_g = np.r_[0, np.cumsum(counts)[:-1]].astype(np.int32)

    # per-shard block_idx/pattern in slot layout (global ids for now)
    block_idx_g = np.zeros((NJ_pad, S), np.int32)
    pattern_g = np.zeros((NJ_pad, S, BS, BS), np.float32)
    block_idx_g[:NJ] = np.asarray(bell.block_idx)
    pattern_g[:NJ] = valid_g.astype(np.float32)
    for j in range(NJ, NJ_pad):
        block_idx_g[j, 0] = j

    A_loc = int(max(
        counts[r * NJ_loc:(r + 1) * NJ_loc].sum() for r in range(P_)
    ))
    A_loc = max(A_loc, 1)

    # per-shard segments, compact remap, routing
    owner = lambda g: g // NJ_loc
    send_lists = [[[] for _ in range(P_)] for _ in range(P_)]  # [o][r]
    uniq_per_shard = []
    a_true, ns_true = [], []
    for r in range(P_):
        lo_t = r * NJ_loc
        lo = starts_g[lo_t]
        hi = lo + counts[lo_t:lo_t + NJ_loc].sum()
        seg = a_src_g[lo:hi]
        uniq = np.unique(seg)
        uniq_per_shard.append(uniq)
        ns_true.append(len(uniq))
        a_true.append(int(hi - lo))
        for g in uniq:
            send_lists[owner(g)][r].append(int(g % NJ_loc))
    NS_max = max(max(ns_true), 1)
    H_max = max(
        max((len(send_lists[o][r]) for o in range(P_) for r in range(P_)),
            default=1), 1
    )

    send_idx = np.zeros((P_, P_, H_max), np.int32)
    recv_map = np.zeros((P_, NS_max), np.int32)
    for o in range(P_):
        for r in range(P_):
            lst = send_lists[o][r]
            send_idx[o, r, : len(lst)] = lst
    for r in range(P_):
        uniq = uniq_per_shard[r]
        # position of each unique block within its owner's send list to r
        pos_in_owner = {}
        cnt = {}
        for g in uniq:
            o = owner(g)
            pos_in_owner[g] = cnt.get(o, 0)
            cnt[o] = cnt.get(o, 0) + 1
        for i, g in enumerate(uniq):
            recv_map[r, i] = owner(g) * H_max + pos_in_owner[g]

    a_src_c = np.zeros((P_, A_loc), np.int32)
    a_tgt = np.zeros((P_, A_loc), np.int32)
    a_slot = np.zeros((P_, A_loc), np.int32)
    tile_start = np.zeros((P_, NJ_loc), np.int32)
    tile_count = np.zeros((P_, NJ_loc), np.int32)
    block_idx_c = np.zeros((P_, NJ_loc, S), np.int32)
    pattern = np.zeros((P_, NJ_loc, S, BS, BS), np.float32)
    pattern_act = np.zeros((P_, A_loc, BS, BS), bool)
    pa_tiles = np.zeros((P_, A_loc, BS, BS), np.float32)
    cheb_tiles = np.zeros((P_, A_loc, K, BS, BS), np.float32)
    src_order = np.zeros((P_, A_loc), np.int32)
    src_start = np.zeros((P_, NS_max), np.int32)
    src_count = np.zeros((P_, NS_max), np.int32)
    max_out = 1
    pa_g = np.asarray(pa_g, np.float32)
    cheb_g = np.asarray(cheb_g, np.float32)
    pat_g = np.asarray(pat_g, bool)
    for r in range(P_):
        lo_t = r * NJ_loc
        lo = starts_g[lo_t]
        n_seg = a_true[r]
        seg = slice(lo, lo + n_seg)
        comp = {int(g): i for i, g in enumerate(uniq_per_shard[r])}
        a_src_c[r, :n_seg] = [comp[int(g)] for g in a_src_g[seg]]
        # padded tail entries point past the tiles (JAX's scatter drops
        # them); the per-rank convs launch only the true entries
        a_tgt[r, n_seg:] = NJ_loc
        a_tgt[r, :n_seg] = a_tgt_g[seg] - lo_t
        a_slot[r, :n_seg] = a_slot_g[seg]
        tile_start[r] = starts_g[lo_t:lo_t + NJ_loc] - lo
        tile_count[r] = counts[lo_t:lo_t + NJ_loc]
        bi = block_idx_g[lo_t:lo_t + NJ_loc].copy()
        for j in range(NJ_loc):
            for s in range(S):
                bi[j, s] = comp.get(int(bi[j, s]), 0)
        block_idx_c[r] = bi
        pattern[r] = pattern_g[lo_t:lo_t + NJ_loc]
        pattern_act[r, :n_seg] = pat_g[seg]
        pa_tiles[r, :n_seg] = pa_g[seg]
        cheb_tiles[r, :n_seg] = cheb_g[seg]
        order = np.argsort(a_src_c[r, :n_seg], kind="stable").astype(np.int32)
        src_order[r, :n_seg] = order
        sc = np.bincount(a_src_c[r, :n_seg], minlength=NS_max).astype(
            np.int32
        )
        src_count[r] = sc
        src_start[r] = np.r_[0, np.cumsum(sc)[:-1]].astype(np.int32)
        if sc.max(initial=0) > max_out:
            max_out = int(sc.max())

    return BellTileShardPlan(
        block_idx=block_idx_c, pattern=pattern,
        tile_start=tile_start, tile_count=tile_count,
        a_src=a_src_c, a_tgt=a_tgt, active_slot=a_slot,
        src_order=src_order, src_start=src_start, src_count=src_count,
        send_idx=send_idx, recv_map=recv_map,
        pattern_act=pattern_act, pa_tiles=pa_tiles, cheb_tiles=cheb_tiles,
        n_nodes=bell.n_nodes, block_size=BS, num_shards=P_,
        ns_max=NS_max, h_max=H_max, max_out=max_out,
        ns_true=tuple(ns_true), a_true=tuple(a_true),
        seg_lo=tuple(int(starts_g[r * NJ_loc]) for r in range(P_)),
    )


@dataclasses.dataclass(frozen=True)
class BellTileOverlapLists:
    """Static per-shard split of the tile list into sublist A (every source
    block is shard-local → the kernel reads x_loc/q_loc directly, with NO
    data dependence on the ``all_to_all``) and sublist B (at least one
    remote source → reads the exchanged compact table). Two kernel calls
    per shard; A's runs between the exchange's start and its wait.

    Sublists are padded across shards by repeating tile 0 with a single
    PAD active entry (zero pattern/cheb → the kernel's masked softmax makes
    its weights exactly zero, so pad copies contribute nothing to any
    gradient); ``sel*`` indexes the shard's A_loc active axis to gather
    per-entry constants/masks, with index A_loc meaning an appended zero
    row. ``inv_pos`` maps each true local tile to its row in
    concat(outA, outB).
    """

    # sublist A (local sources; a_src are LOCAL block ids 0..NJ_loc-1)
    tilesA: np.ndarray        # (P, NJA) int32 local tile ids
    tile_startA: np.ndarray   # (P, NJA) int32
    tile_countA: np.ndarray   # (P, NJA) int32
    a_srcA: np.ndarray        # (P, ALA) int32
    a_tgtA: np.ndarray        # (P, ALA) int32 (position in sublist A)
    slotA: np.ndarray         # (P, ALA) int32
    selA: np.ndarray          # (P, ALA) int32 into [0, A_loc]
    block_idxA: np.ndarray    # (P, NJA, S) int32
    patternA: np.ndarray      # (P, NJA, S, BS, BS) f32
    src_orderA: np.ndarray    # (P, ALA) int32
    src_startA: np.ndarray    # (P, NJ_loc) int32
    src_countA: np.ndarray    # (P, NJ_loc) int32
    max_outA: int
    # sublist B (halo-dependent; a_src are COMPACT table ids)
    tilesB: np.ndarray
    tile_startB: np.ndarray
    tile_countB: np.ndarray
    a_srcB: np.ndarray
    a_tgtB: np.ndarray
    slotB: np.ndarray
    selB: np.ndarray
    block_idxB: np.ndarray
    patternB: np.ndarray
    src_orderB: np.ndarray
    src_startB: np.ndarray    # (P, NS_max) int32
    src_countB: np.ndarray
    max_outB: int
    # reassembly
    inv_pos: np.ndarray       # (P, NJ_loc) int32 row in concat(A, B)
    n_localA: tuple           # true sublist-A tile count per shard
    exposed_blocks: tuple     # per shard: compact blocks only B waits for


def build_overlap_lists(plan: BellTileShardPlan) -> BellTileOverlapLists:
    """Split each shard's tile list for halo/compute overlap (static)."""
    P_ = plan.num_shards
    NJ_loc = plan.tiles_per_shard
    S = plan.block_idx.shape[2]
    BS = plan.block_size
    H_max = plan.h_max

    per_shard = []
    for r in range(P_):
        owners = plan.recv_map[r] // H_max          # (NS_max,)
        slot_in_owner = plan.recv_map[r] % H_max
        # local block id behind each LOCAL compact id
        local_of_compact = np.where(
            owners == r, plan.send_idx[r, r][slot_in_owner], -1
        )
        tilesA, tilesB = [], []
        for j in range(NJ_loc):
            lo = plan.tile_start[r, j]
            cnt = plan.tile_count[r, j]
            srcs = plan.a_src[r, lo:lo + cnt]
            if np.all(owners[srcs] == r):
                tilesA.append(j)
            else:
                tilesB.append(j)
        # compact blocks that only sublist B actually waits for
        b_srcs = set()
        for j in tilesB:
            lo = plan.tile_start[r, j]
            b_srcs.update(plan.a_src[r, lo:lo + plan.tile_count[r, j]])
        per_shard.append((tilesA, tilesB, local_of_compact, len(b_srcs)))

    NJA = max(max(len(t[0]) for t in per_shard), 1)
    NJB = max(max(len(t[1]) for t in per_shard), 1)

    def build_side(side, NJ_sub, n_src_rows):
        ALs = []
        for r in range(P_):
            tiles = per_shard[r][side]
            ALs.append(
                sum(int(plan.tile_count[r, j]) for j in tiles)
                + (NJ_sub - len(tiles))      # one pad entry per pad tile
            )
        AL = max(max(ALs), 1)
        t_ids = np.zeros((P_, NJ_sub), np.int32)
        t_start = np.zeros((P_, NJ_sub), np.int32)
        t_count = np.ones((P_, NJ_sub), np.int32)
        a_src = np.zeros((P_, AL), np.int32)
        a_tgt = np.zeros((P_, AL), np.int32)
        slot = np.zeros((P_, AL), np.int32)
        sel = np.full((P_, AL), plan.a_src.shape[1], np.int32)  # → zero row
        bidx = np.zeros((P_, NJ_sub, S), np.int32)
        pat = np.zeros((P_, NJ_sub, S, BS, BS), np.float32)
        s_order = np.zeros((P_, AL), np.int32)
        s_start = np.zeros((P_, n_src_rows), np.int32)
        s_count = np.zeros((P_, n_src_rows), np.int32)
        max_out = 1
        for r in range(P_):
            local_of_compact = per_shard[r][2]
            tiles = per_shard[r][side]
            pos = 0
            for t_pos in range(NJ_sub):
                t_start[r, t_pos] = pos
                if t_pos < len(tiles):
                    j = tiles[t_pos]
                    t_ids[r, t_pos] = j
                    lo = int(plan.tile_start[r, j])
                    cnt = int(plan.tile_count[r, j])
                    t_count[r, t_pos] = cnt
                    for s in range(cnt):
                        comp = int(plan.a_src[r, lo + s])
                        a_src[r, pos] = (
                            local_of_compact[comp] if side == 0 else comp
                        )
                        a_tgt[r, pos] = t_pos
                        slot[r, pos] = s
                        sel[r, pos] = lo + s
                        pat[r, t_pos, s] = plan.pattern[r, j, s]
                        bidx[r, t_pos, s] = a_src[r, pos]
                        pos += 1
                else:
                    # pad tile: repeat tile 0's identity for k/output rows,
                    # ONE pad active entry (zero pattern → zero weights)
                    t_ids[r, t_pos] = t_ids[r, 0]
                    a_src[r, pos] = 0
                    a_tgt[r, pos] = t_pos
                    slot[r, pos] = 0
                    pos += 1
            # pad the active tail past pos (a_tgt → NJ_sub scatters OOB)
            a_tgt[r, pos:] = NJ_sub
            # source-sorted view for the fused backward
            n_act = pos
            order = np.argsort(
                a_src[r, :n_act], kind="stable"
            ).astype(np.int32)
            s_order[r, :n_act] = order
            sc = np.bincount(a_src[r, :n_act], minlength=n_src_rows).astype(
                np.int32
            )
            s_count[r] = sc
            s_start[r] = np.r_[0, np.cumsum(sc)[:-1]].astype(np.int32)
            if sc.max(initial=0) > max_out:
                max_out = int(sc.max())
        return (t_ids, t_start, t_count, a_src, a_tgt, slot, sel, bidx, pat,
                s_order, s_start, s_count, max_out)

    A = build_side(0, NJA, NJ_loc)
    Bb = build_side(1, NJB, plan.ns_max)

    inv_pos = np.zeros((P_, NJ_loc), np.int32)
    for r in range(P_):
        tilesA, tilesB = per_shard[r][0], per_shard[r][1]
        for pos, j in enumerate(tilesA):
            inv_pos[r, j] = pos
        for pos, j in enumerate(tilesB):
            inv_pos[r, j] = NJA + pos

    return BellTileOverlapLists(
        tilesA=A[0], tile_startA=A[1], tile_countA=A[2], a_srcA=A[3],
        a_tgtA=A[4], slotA=A[5], selA=A[6], block_idxA=A[7], patternA=A[8],
        src_orderA=A[9], src_startA=A[10], src_countA=A[11], max_outA=A[12],
        tilesB=Bb[0], tile_startB=Bb[1], tile_countB=Bb[2], a_srcB=Bb[3],
        a_tgtB=Bb[4], slotB=Bb[5], selB=Bb[6], block_idxB=Bb[7],
        patternB=Bb[8], src_orderB=Bb[9], src_startB=Bb[10],
        src_countB=Bb[11], max_outB=Bb[12],
        inv_pos=inv_pos,
        n_localA=tuple(len(t[0]) for t in per_shard),
        exposed_blocks=tuple(t[3] for t in per_shard),
    )


# ---------------------------------------------------------------------------
# the per-rank convs
# ---------------------------------------------------------------------------

class RankTiles:
    """One rank's tile structure in the form ``BellTilesOut`` walks (the
    fields of a BlockEllGraph's ``tensors``), its target and source axes
    padded to ``num_tiles`` = R blocks: the padding targets have no active
    entry, the padding sources no outgoing tile."""

    def __init__(self, tile_start, tile_count, a_src, a_tgt, n_src: int, device):
        n_tgt, n = len(tile_count), len(a_src)
        R = max(n_src, n_tgt)
        ts = np.full(R, n, np.int32)
        tc = np.zeros(R, np.int32)
        ts[:n_tgt], tc[:n_tgt] = tile_start, tile_count
        a_src = np.asarray(a_src, np.int32)
        sc = np.bincount(a_src, minlength=R).astype(np.int32)
        arrays = {
            "tile_start": ts, "tile_count": tc, "active_src": a_src,
            "active_tgt": np.asarray(a_tgt, np.int32),
            "src_order": np.argsort(a_src, kind="stable").astype(np.int32),
            "src_start": np.r_[0, np.cumsum(sc)[:-1]].astype(np.int32),
            "src_count": sc,
        }
        self.tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                        for k, v in arrays.items()}
        self.num_tiles = R
        self.n_targets = n_tgt
        self.num_active = n


def _tiles_out(tiles: RankTiles, q_src, k_tgt, bias_t, cheb_t, x_src, thetas, pattern_t,
               BS, n_heads, d_k):
    """F (and, in the backward, K1 and K2) on one rank's tile list: q_src
    (B, ·, H·d_k) and x_src (B, ·, C·T) source rows, k_tgt (B, ·, H·d_k)
    target rows → (B, n_targets·BS, Co·T) in x's dtype."""
    B = x_src.shape[0]
    rows = tiles.num_tiles * BS
    q = pad_nodes(q_src, 1, rows).reshape(B, rows, n_heads, d_k).contiguous()
    k = pad_nodes(k_tgt, 1, rows).reshape(B, rows, n_heads, d_k).contiguous()
    x = pad_nodes(x_src, 1, rows).contiguous()
    out = BellTilesOut.apply(q, k, bias_t.contiguous(), cheb_t.contiguous(), x,
                             thetas.float().contiguous(), tiles, pattern_t)
    return out[:, :tiles.n_targets * BS]


_CACHE: dict = {}


def _cached(key, plans, build):
    """Per-(plan, rank, device) host-built tensors, kept with their plans
    (whose ids are the key) so the ids stay theirs."""
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = (plans, build())
    return hit[1]


def partitioned_bell_conv(
    mesh,
    emb: torch.Tensor,
    x: torch.Tensor,
    plan: BellShardPlan,
    *,
    adj_pa: torch.Tensor,
    masks: torch.Tensor,
    cheb_polys: torch.Tensor,
    thetas: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """Dense-mask partitioned BELL conv: emb (B, Np/P, d_model) and x (B,
    Np/P, C, T), this rank's rows → (B, Np/P, Co, T), its rows. The planes
    are padded to the plan's block grid, the edge pattern is folded into
    the bias plane (−1e30 off-pattern), the rank takes its target columns
    of the (K, Np, Np) planes, all-gathers every rank's q and x rows, and
    runs F on its tiles (global source ids)."""
    B, nloc, C, T = x.shape
    Co = thetas.shape[-1]
    BS, P_, g, grp = plan.block_size, plan.num_shards, mesh.g, mesh.graph_group
    NJ_loc = plan.tiles_per_shard
    NJ_pad, Np = P_ * NJ_loc, plan.padded_nodes
    dev = x.device

    def build():
        n = int(plan.tile_count[g].sum())
        a_src, a_tgt = plan.a_src[g][:n], plan.a_tgt[g][:n]
        adj = plan.adj_bool.reshape(NJ_pad, BS, NJ_pad, BS).transpose(0, 2, 1, 3)
        pattern = adj[a_src, a_tgt + g * NJ_loc]
        return (RankTiles(plan.tile_start[g], plan.tile_count[g], a_src, a_tgt, NJ_pad, dev),
                torch.from_numpy(np.ascontiguousarray(pattern)).to(dev),
                torch.from_numpy(plan.adj_bool).to(dev),
                torch.from_numpy(a_src.astype(np.int64)).to(dev),
                torch.from_numpy(a_tgt.astype(np.int64)).to(dev))

    tiles, pattern_t, adj_bool, a_src, a_tgt = _cached((id(plan), g, str(dev)), plan, build)
    f32 = torch.float32
    bias_p = pad_nodes(pad_nodes((adj_pa[None] * masks).to(f32), 1, Np), 2, Np)
    biasm_p = torch.where(adj_bool[None], bias_p, torch.tensor(_NEG, dtype=f32, device=dev))
    cheb_p = pad_nodes(pad_nodes(cheb_polys.to(f32), 1, Np), 2, Np)
    x_l = x.reshape(B, nloc, C * T)
    biasm_l = comm.enter(biasm_p, 2, grp)    # this rank's target columns
    cheb_l = comm.enter(cheb_p, 2, grp)
    thetas, wq, wk = (comm.copy_to(w, grp) for w in (thetas, wq, wk))
    q_loc = (emb @ wq).to(f32)
    k_loc = (emb @ wk).to(f32)
    q_all = comm.gather_rows(q_loc, 1, grp)
    x_all = comm.gather_rows(x_l, 1, grp)
    K = biasm_l.shape[0]

    def tiles_of(plane):  # (K, Np, NJ_loc·BS) → (A, K, BS, BS) at the rank's entries
        p5 = plane.reshape(K, NJ_pad, BS, NJ_loc, BS).permute(1, 3, 0, 2, 4)
        return p5[a_src, a_tgt]

    out = _tiles_out(tiles, q_all, k_loc, tiles_of(biasm_l), tiles_of(cheb_l), x_all, thetas,
                     pattern_t, BS, n_heads, d_k)
    return out.reshape(B, nloc, Co, T).to(x.dtype)


def _exchange_send(v: torch.Tensor, send_idx: torch.Tensor, NJ_loc: int, BS: int):
    """(B, NJ_loc·BS, D) rows → (P, H_max, B, BS, D): send[r, h] is the
    local block this rank ships to rank r in slot h."""
    B, _, D = v.shape
    blocks = v.reshape(B, NJ_loc, BS, D)
    return blocks[:, send_idx].permute(1, 2, 0, 3, 4).contiguous()


def _compact(recv: torch.Tensor, recv_map: torch.Tensor) -> torch.Tensor:
    """recv (P, H_max, B, BS, D), ``recv[o, h]`` owner o's slot h → the
    compact source table (B, NS_max·BS, D)."""
    P_, H, B, BS, D = recv.shape
    comp = recv.reshape(P_ * H, B, BS, D)[recv_map]
    return comp.permute(1, 0, 2, 3).reshape(B, -1, D)


def _rank_tile_consts(plan: BellTileShardPlan, g: int, dev):
    """The rank's routing tables and per-entry constants on ``dev``."""
    t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(
        a if dt is None else a.astype(dt))).to(dev)
    return {"send_idx": t(plan.send_idx[g], np.int64),
            "recv_map": t(plan.recv_map[g], np.int64),
            "pattern_act": t(plan.pattern_act[g]), "pa_tiles": t(plan.pa_tiles[g]),
            "cheb_tiles": t(plan.cheb_tiles[g])}


def _bias_tiles(pattern_act, pa_tiles, mask):
    """adj_pa ⊙ mask on the pattern, −1e30 elsewhere (A, K, BS, BS) f32."""
    return torch.where(pattern_act[:, None], (pa_tiles[:, None] * mask).float(),
                       torch.tensor(_NEG, dtype=torch.float32, device=mask.device))


def _tile_operands(mesh, emb, x, wq, wk, thetas):
    """The rank's x rows as the kernels read them (B, Np/P, C·T), its q
    and k (float32) and the whole weights inside the region."""
    B, nloc, C, T = x.shape
    thetas, wq, wk = (comm.copy_to(w, mesh.graph_group) for w in (thetas, wq, wk))
    return x.reshape(B, nloc, C * T), (emb @ wq).float(), (emb @ wk).float(), thetas


def partitioned_bell_tiles_conv(
    mesh,
    emb: torch.Tensor,
    x: torch.Tensor,
    plan: BellTileShardPlan,
    *,
    mask_tiles: torch.Tensor,
    thetas: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """Tile-resident partitioned BELL conv with the targeted block halo:
    emb (B, Np/P, d_model) and x (B, Np/P, C, T), this rank's rows, and
    ``mask_tiles`` its (A_loc, K, BS, BS) slice → (B, Np/P, Co, T), its
    rows. The rank projects its rows to q and k, one all-to-all per operand
    fills its compact source table, and F runs on its tile list (K1 and K2
    in the backward, whose dx routes back through the reverse
    all-to-all)."""
    B, nloc, C, T = x.shape
    Co = thetas.shape[-1]
    BS, g, grp = plan.block_size, mesh.g, mesh.graph_group
    NJ_loc, dev = plan.tiles_per_shard, x.device

    def build():
        n = plan.a_true[g]
        return (RankTiles(plan.tile_start[g], plan.tile_count[g], plan.a_src[g][:n],
                          plan.a_tgt[g][:n], plan.ns_max, dev),
                _rank_tile_consts(plan, g, dev))

    tiles, cs = _cached((id(plan), g, str(dev)), plan, build)
    n = tiles.num_active
    x_l, q_loc, k_loc, thetas = _tile_operands(mesh, emb, x, wq, wk, thetas)
    x_c = _compact(comm.exchange(_exchange_send(x_l, cs["send_idx"], NJ_loc, BS), grp),
                   cs["recv_map"])
    q_c = _compact(comm.exchange(_exchange_send(q_loc, cs["send_idx"], NJ_loc, BS), grp),
                   cs["recv_map"])
    pattern = cs["pattern_act"][:n]
    bias_t = _bias_tiles(pattern, cs["pa_tiles"][:n], mask_tiles[:n])
    out = _tiles_out(tiles, q_c, k_loc, bias_t, cs["cheb_tiles"][:n], x_c, thetas, pattern,
                     BS, n_heads, d_k)
    return out.reshape(B, nloc, Co, T).to(x.dtype)


def partitioned_bell_tiles_conv_overlap(
    mesh,
    emb: torch.Tensor,
    x: torch.Tensor,
    plan: BellTileShardPlan,
    ov: BellTileOverlapLists,
    *,
    mask_tiles: torch.Tensor,
    thetas: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """The overlapped variant of :func:`partitioned_bell_tiles_conv`: both
    all-to-alls are started, F runs sublist A on the rank's own rows, then
    the exchange is waited on and F runs sublist B on the compact table.
    Two F launches a forward, two K1 and two K2 a backward."""
    B, nloc, C, T = x.shape
    Co = thetas.shape[-1]
    BS, g, grp = plan.block_size, mesh.g, mesh.graph_group
    NJ_loc, dev = plan.tiles_per_shard, x.device

    def side(tiles_ids, t_start, t_count, a_src, a_tgt, sel, n_src):
        n = int(t_start[-1] + t_count[-1])
        return (RankTiles(t_start, t_count, a_src[:n], a_tgt[:n], n_src, dev),
                torch.from_numpy(tiles_ids.astype(np.int64)).to(dev),
                torch.from_numpy(sel[:n].astype(np.int64)).to(dev))

    def build():
        return (_rank_tile_consts(plan, g, dev),
                side(ov.tilesA[g], ov.tile_startA[g], ov.tile_countA[g], ov.a_srcA[g],
                     ov.a_tgtA[g], ov.selA[g], NJ_loc),
                side(ov.tilesB[g], ov.tile_startB[g], ov.tile_countB[g], ov.a_srcB[g],
                     ov.a_tgtB[g], ov.selB[g], plan.ns_max),
                torch.from_numpy(ov.inv_pos[g].astype(np.int64)).to(dev))

    cs, sideA, sideB, inv_pos = _cached((id(plan), id(ov), g, str(dev)), (plan, ov), build)
    x_l, q_loc, k_loc, thetas = _tile_operands(mesh, emb, x, wq, wk, thetas)
    send_x = _exchange_send(x_l, cs["send_idx"], NJ_loc, BS)
    send_q = _exchange_send(q_loc, cs["send_idx"], NJ_loc, BS)
    pend_x, pend_q = comm.exchange_start(send_x, grp), comm.exchange_start(send_q, grp)
    zrow = lambda a: torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
    consts = [zrow(cs[k]) for k in ("pattern_act", "pa_tiles", "cheb_tiles")]
    mask_z = zrow(mask_tiles)
    H = k_loc.shape[-1]

    def run(sd, q_src, x_src):
        tiles, ids, sel = sd
        pattern, pa, cheb = (c[sel] for c in consts)
        k_t = k_loc.reshape(B, NJ_loc, BS, H)[:, ids].reshape(B, -1, H)
        return _tiles_out(tiles, q_src, k_t, _bias_tiles(pattern, pa, mask_z[sel]), cheb,
                          x_src, thetas, pattern, BS, n_heads, d_k)

    out_a = run(sideA, q_loc, x_l)  # local sources only: no wait on the exchange
    x_c = _compact(comm.exchange_finish(send_x, pend_x), cs["recv_map"])
    q_c = _compact(comm.exchange_finish(send_q, pend_q), cs["recv_map"])
    out_b = run(sideB, q_c, x_c)
    Mo = out_a.shape[-1]
    cat = torch.cat([out_a.reshape(B, -1, BS, Mo), out_b.reshape(B, -1, BS, Mo)], dim=1)
    return cat[:, inv_pos].reshape(B, nloc, Co, T).to(x.dtype)
