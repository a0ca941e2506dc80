"""Block-ELL (BELL) sparse graph structures and the plain block-sparse
spatial path.

Counterpart of ``dstagnn_drought_tpu/ops/block_sparse.py``. Nodes are tiled
into blocks of ``BS``; for every target tile j the graph keeps the source
blocks with at least one in-edge into j (``block_idx``/``block_mask``) and
the dense edge pattern of each such tile (``pattern``). The flat *active
list* (``active_src``/``active_tgt``, target-sorted, with ``tile_start``/
``tile_count`` per target tile and a source-sorted view ``src_order``/
``src_start``/``src_count``) is what the CUDA kernels of
``ops/cuda/bell_fused.py`` and ``ops/cuda/bell_bwd.py`` walk. Work scales
with the number of active tiles instead of N².

The structures are built on the host with numpy (bit-identical to the JAX
package's builders); each graph also carries its arrays as torch tensors,
which :meth:`BlockEllGraph.to` moves to a device. :func:`block_sparse_spatial_attention_scores` and
:func:`block_sparse_cheb_conv_with_sat` are the plain path the model runs
with ``sparse_format=bell`` and ``use_pallas`` off: softmax over each
target's true in-neighbourhood (off-pattern and padding slots get -1e30
before the softmax).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NEG = -1e30
# host arrays that also travel to the device; the (Np, Np) ``adj_bool``
# stays on the host, since no device path reads it
_DEVICE_FIELDS = (
    "block_idx", "block_mask", "pattern", "active_src", "active_tgt",
    "tile_start", "tile_count", "active_slot", "src_order",
    "src_start", "src_count",
)


@dataclasses.dataclass
class BlockEllGraph:
    """Block-sparse description of a directed graph (source i → target j).

    For target tile j, slot s: ``block_idx[j, s]`` is a source block,
    ``block_mask[j, s]`` says whether the slot is real, ``pattern[j, s]`` is
    the (BS, BS) edge pattern of that tile (True where source node
    ``block_idx[j,s]*BS + a`` has an edge into target ``j*BS + b``). Fields
    are numpy arrays; ``tensors`` holds the same arrays as torch tensors,
    on the CPU until :meth:`to` moves them (see :func:`_to_tensors`).
    """

    block_idx: np.ndarray    # (NJ, S) int32
    block_mask: np.ndarray   # (NJ, S) bool
    pattern: np.ndarray      # (NJ, S, BS, BS) bool
    n_nodes: int             # true (unpadded) node count
    active_src: np.ndarray   # (A,) int32 source block of each active tile
    active_tgt: np.ndarray   # (A,) int32 target tile of each active tile
    tile_start: np.ndarray   # (NJ,) int32 offset of tile j's slots
    tile_count: np.ndarray   # (NJ,) int32 active slots of tile j
    adj_bool: np.ndarray     # (Np, Np) bool padded edge pattern
    active_slot: np.ndarray  # (A,) int32 slot of each entry in its tile
    src_order: np.ndarray    # (A,) int32 active indices in source order
    src_start: np.ndarray    # (NJ,) int32
    src_count: np.ndarray    # (NJ,) int32
    covered: bool = True     # every real target column has an in-edge
    max_src_blocks: int = 0  # most outgoing active tiles of any source tile
    tensors: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.tensors:
            self.tensors = _to_tensors(self)

    def to(self, device) -> "BlockEllGraph":
        """The same graph with its device tensors on ``device``."""
        return dataclasses.replace(
            self, tensors={k: v.to(device) for k, v in self.tensors.items()})

    def active_pattern(self) -> np.ndarray:
        """(A, BS, BS) bool: the edge pattern of each active tile."""
        valid = self.pattern & self.block_mask[:, :, None, None]
        return valid[self.active_tgt, self.active_slot]

    @property
    def block_size(self) -> int:
        return self.pattern.shape[-1]

    @property
    def num_tiles(self) -> int:
        return self.block_idx.shape[0]

    @property
    def max_blocks(self) -> int:
        return self.block_idx.shape[1]

    @property
    def padded_nodes(self) -> int:
        return self.num_tiles * self.block_size

    @property
    def num_active(self) -> int:
        return self.active_src.shape[0]


def _to_tensors(g: BlockEllGraph) -> dict:
    """Every index array as the int32 the CUDA kernels take (torch indexing
    accepts it too), masks as bool, with ``active_pattern`` the
    per-active-tile edge pattern."""
    out = {"active_pattern": torch.from_numpy(np.ascontiguousarray(g.active_pattern()))}
    for name in _DEVICE_FIELDS:
        out[name] = torch.from_numpy(np.ascontiguousarray(getattr(g, name)))
    return out


def rcm_permutation(adj: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee node ordering (bandwidth reduction).

    Returns ``perm`` with ``reordered = adj[np.ix_(perm, perm)]``. BFS over
    the symmetrized pattern from the lowest-degree unvisited seed, neighbours
    in stable degree order; deterministic (ties broken by node id).
    """
    A = np.asarray(adj) != 0
    A = A | A.T
    np.fill_diagonal(A, False)
    n = A.shape[0]
    deg = A.sum(axis=1)
    visited = np.zeros(n, dtype=bool)
    order: list[int] = []
    neighbors = [np.nonzero(A[i])[0] for i in range(n)]
    while len(order) < n:
        seed = int(np.argmin(np.where(visited, np.iinfo(np.int64).max, deg)))
        queue = [seed]
        visited[seed] = True
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            order.append(v)
            nbrs = neighbors[v]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(int(u) for u in nbrs)
    return np.asarray(order[::-1], dtype=np.int64)


def block_ell_from_adjacency(
    adj: np.ndarray,
    block_size: int = 128,
    include_self: bool = True,
    max_blocks: int | None = None,
) -> BlockEllGraph:
    """Dense 0/1 adjacency (``adj[i, j] != 0``: i is an in-neighbour of
    target j) → :class:`BlockEllGraph`. The node axis is zero-padded to a
    block multiple; padding rows and columns carry no edges. A target tile
    with no in-edges gets a dummy active entry (j, j) so every output tile
    is visited once; such a graph is not ``covered``."""
    A = np.asarray(adj) != 0
    n = A.shape[0]
    if include_self:
        A = A | np.eye(n, dtype=bool)
    BS = block_size
    n_pad = -(-n // BS) * BS
    Ap = np.zeros((n_pad, n_pad), dtype=bool)
    Ap[:n, :n] = A
    nb = n_pad // BS
    tiles = Ap.reshape(nb, BS, nb, BS)
    active = tiles.any(axis=(1, 3))  # (src_block, tgt_block)
    S = int(active.sum(axis=0).max()) if max_blocks is None else max_blocks
    S = max(S, 1)
    block_idx = np.zeros((nb, S), dtype=np.int32)
    block_mask = np.zeros((nb, S), dtype=bool)
    pattern = np.zeros((nb, S, BS, BS), dtype=bool)
    a_src: list[int] = []
    a_tgt: list[int] = []
    for j in range(nb):
        srcs = np.nonzero(active[:, j])[0][:S]
        block_idx[j, : len(srcs)] = srcs
        block_mask[j, : len(srcs)] = True
        for s, sb in enumerate(srcs):
            pattern[j, s] = tiles[sb, :, j, :]
        if len(srcs):
            a_src.extend(int(s) for s in srcs)
            a_tgt.extend([j] * len(srcs))
        else:
            a_src.append(j)
            a_tgt.append(j)
    a_src_np = np.asarray(a_src, np.int32)
    a_tgt_np = np.asarray(a_tgt, np.int32)
    t_count = np.bincount(a_tgt_np, minlength=nb).astype(np.int32)
    t_start = np.r_[0, np.cumsum(t_count)[:-1]].astype(np.int32)
    a_slot = (np.arange(len(a_tgt_np), dtype=np.int32)
              - t_start[a_tgt_np]).astype(np.int32)
    s_order = np.argsort(a_src_np, kind="stable").astype(np.int32)
    s_count = np.bincount(a_src_np, minlength=nb).astype(np.int32)
    s_start = np.r_[0, np.cumsum(s_count)[:-1]].astype(np.int32)
    # coverage of the structure the kernels visit (``max_blocks`` may
    # truncate a target's slot list)
    kept = pattern & block_mask[:, :, None, None]
    col_covered = kept.any(axis=(1, 2)).reshape(n_pad)
    return BlockEllGraph(
        block_idx, block_mask, pattern, n_nodes=n,
        active_src=a_src_np, active_tgt=a_tgt_np,
        tile_start=t_start, tile_count=t_count, adj_bool=Ap,
        active_slot=a_slot, src_order=s_order,
        src_start=s_start, src_count=s_count,
        covered=bool(col_covered[:n].all()),
        max_src_blocks=int(s_count.max()) if len(s_count) else 0,
    )


def active_tile_values(dense, bell: BlockEllGraph) -> np.ndarray:
    """(..., N, N) dense (source, target) matrix → (A, ..., BS, BS) values
    at the active tiles, in active-list order (host numpy)."""
    d = np.asarray(dense)
    BS, NJ = bell.block_size, bell.num_tiles
    n_pad = bell.padded_nodes
    pad = [(0, 0)] * (d.ndim - 2) + [
        (0, n_pad - d.shape[-2]), (0, n_pad - d.shape[-1])
    ]
    d = np.pad(d, pad)
    lead = d.shape[:-2]
    d = d.reshape(*lead, NJ, BS, NJ, BS)
    d = np.moveaxis(d, (-4, -2), (0, 1))
    return d[bell.active_src, bell.active_tgt]


def build_bell_tile_constants(bell: BlockEllGraph, adj_pa, cheb_polys,
                              device="cpu") -> dict:
    """Per-active-tile constants of the tile-resident path: {'pattern_tiles'
    (A, BS, BS) bool, 'pa_tiles' (A, BS, BS) f32, 'cheb_tiles' (A, K, BS, BS)
    f32} on ``device``. Nothing O(N²) needs to live on the device."""
    out = {
        "pattern_tiles": bell.active_pattern(),
        "pa_tiles": active_tile_values(np.asarray(adj_pa), bell).astype(np.float32),
        "cheb_tiles": active_tile_values(np.asarray(cheb_polys), bell).astype(np.float32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def pad_node_axis(x: torch.Tensor, bell: BlockEllGraph, axis: int) -> torch.Tensor:
    """Zero-pad a node axis up to the block grid size."""
    extra = bell.padded_nodes - x.shape[axis]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def gather_block_values(dense: torch.Tensor, bell: BlockEllGraph) -> torch.Tensor:
    """(..., N, N) dense (source, target) matrix → (..., NJ, S, BS, BS)
    values at the slot structure (zero-padded to the block grid first)."""
    BS, NJ = bell.block_size, bell.num_tiles
    d = pad_node_axis(pad_node_axis(dense, bell, -2), bell, -1)
    lead = d.shape[:-2]
    d = d.reshape(*lead, NJ, BS, NJ, BS)
    d = d.movedim(-2, -4)  # (..., j, sb, a, b)
    j = torch.arange(NJ, device=d.device)[:, None]
    return d[..., j, bell.tensors["block_idx"], :, :]  # (..., NJ, S, BS, BS)


def block_sparse_spatial_attention_scores(
    x: torch.Tensor,
    bell: BlockEllGraph,
    *,
    wq: torch.Tensor,
    wk: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """Block SDDMM: x (B, N, d_model) → raw scores (B, H, NJ, S, BS, BS),
    score[b,h,j,s,a,c] = Q[src]·K[tgt]/√d_k for src = block_idx[j,s]·BS+a,
    tgt = j·BS+c."""
    B, N, _ = x.shape
    BS, NJ = bell.block_size, bell.num_tiles
    q = torch.einsum("bnd,dh->bnh", x, wq).reshape(B, N, n_heads, d_k)
    k = torch.einsum("bnd,dh->bnh", x, wk).reshape(B, N, n_heads, d_k)
    q = pad_node_axis(q, bell, 1).reshape(B, NJ, BS, n_heads, d_k)
    k = pad_node_axis(k, bell, 1).reshape(B, NJ, BS, n_heads, d_k)
    q_blocks = q[:, bell.tensors["block_idx"]]  # (B, NJ, S, BS, H, d_k)
    scores = torch.einsum("bjsahd,bjchd->bhjsac", q_blocks, k)
    return scores / torch.full((), float(d_k), dtype=x.dtype, device=x.device).sqrt()


def block_sparse_cheb_conv_with_sat(
    x: torch.Tensor,
    block_scores: torch.Tensor,
    bell: BlockEllGraph,
    *,
    cheb_blocks: torch.Tensor,
    bias_blocks: torch.Tensor,
    thetas: torch.Tensor,
) -> torch.Tensor:
    """Block-sparse attention-modulated Chebyshev conv.

    x (B, N, C, T); block_scores (B, K, NJ, S, BS, BS); cheb_blocks and
    bias_blocks (K, NJ, S, BS, BS); thetas (K, C, C_out) → (B, N, C_out, T),
    ReLU applied. The softmax runs over each target's neighbourhood (slot
    and source-row axes); entries outside ``pattern`` get -1e30 first.
    """
    B, N, C, T = x.shape
    BS, NJ, S = bell.block_size, bell.num_tiles, bell.max_blocks
    valid = bell.tensors["pattern"] & bell.tensors["block_mask"][:, :, None, None]
    s = block_scores + bias_blocks[None]
    s = torch.where(valid[None, None], s, _NEG)
    K = s.shape[1]
    s2 = s.permute(0, 1, 2, 5, 3, 4).reshape(B, K, NJ, BS, S * BS)
    att = torch.softmax(s2, dim=-1).reshape(B, K, NJ, BS, S, BS)
    att = att.permute(0, 1, 2, 4, 5, 3)  # (B, K, NJ, S, BS_src, BS_tgt)
    A = cheb_blocks[None] * att * valid[None, None]
    xm = pad_node_axis(x.reshape(B, N, C * T), bell, 1).reshape(B, NJ, BS, C * T)
    x_blocks = xm[:, bell.tensors["block_idx"]]  # (B, NJ, S, BS, C·T)
    agg = torch.einsum("zkjsuv,zjsum->zkjvm", A, x_blocks)
    agg = agg.reshape(B, K, NJ * BS, C, T)[:, :, :N]
    out = torch.einsum("bkjct,kco->bjot", agg, thetas)
    return torch.relu(out)

