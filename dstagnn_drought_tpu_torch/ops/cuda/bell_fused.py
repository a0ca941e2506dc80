"""Fused block-sparse (BELL) attention-modulated Chebyshev conv: the CUDA
forward kernel, its plain PyTorch version, the differentiable wrapper and
the two model-facing functions.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/bell_fused.py``. Per batch
b, target tile j and head h, over the active slots u of j (source block
s_u), with every tensor in the one c-major layout of the port:

    scores_u = Q[s_u]·K[j]ᵀ/√d_k + bias_u            (bias = −1e30 off-pattern)
    w_u      = T_k,u ⊙ softmax over (u, source row) of the scores,
               rounded to x's dtype
    out[j]   = relu(Σ_h (Σ_u w_uᵀ · X[s_u]) · Θ_h)   (f32 sums)

q, k (B, Np, H, d_k), bias and cheb tiles (A, H, BS, BS) and Θ (H, C, Co)
are float32; x (B, Np, C·T) and the output (B, Np, Co·T) are in the compute
dtype. The kernel (``csrc/bell_fused.cu``; its header says what bounds it)
keeps the (B, H, Np, C·T) aggregation out of device memory: the Θ mix and
the ReLU run in its epilogue. One design for both dtypes: the SpMM and the
Θ mix on the tensor cores (WMMA) in chunks of 8 time steps, channels in
chunks whose mixes add up in float32 (JAX's c-major M-tiles), output
columns tiled across blocks where one block's sums cannot hold them, agg
and Θ split into bf16 hi + lo where they meet (and float32 x and w where
staged), so the mix stays float32 in value (:func:`f_plan` sizes its
tiles); the weights pass takes d_k in chunks. :func:`limit_error` is the
one gate of the three BELL kernels. On a CUDA tensor :func:`bell_forward`
launches the kernel or raises; :func:`bell_forward_plain` serves CPU
tensors only. ``launches`` counts kernel launches.

The backward (:func:`_backward`) is the active-list organisation of the
JAX package's ``_bwd_tiles_active``: the softmax is recomputed with tensor
ops (segment max/sum over the target-sorted list), K1 and K2
(``ops/cuda/bell_bwd.py``) give dA, dΘ and dx, and the softmax backward,
dq, dk and dbias stay tensor ops. It runs at every feature width: the TPU
package's ``T·C >= 1024`` gate and ``layout="auto"`` VMEM probe are TPU
policy and are not carried over.
"""
from __future__ import annotations

import ctypes
import math

import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.block_sparse import BlockEllGraph, pad_node_axis
from dstagnn_drought_tpu_torch.ops.cuda import bell_bwd, build

launches = 0
_NEG = -1e30


def _tgt_of(tile_start, tile_count):
    """Target tile of each active entry, from the per-tile counts."""
    return torch.repeat_interleave(
        torch.arange(tile_count.shape[0], device=tile_count.device), tile_count.long())


def active_softmax(q, k, bias_t, active_src, active_tgt, n_tiles):
    """The neighbourhood softmax on the active list.

    Returns (q_act, k_act, att): q and k rows per active tile (B, A, BS, H,
    d_k) and att (B, A, H, BS_src, BS_tgt) float32, normalised per target
    column over every slot of its tile (segment max and sum over the
    target-sorted list)."""
    B, Np, H, dk = q.shape
    BS = bias_t.shape[-1]
    q_act = q.reshape(B, -1, BS, H, dk)[:, active_src]
    k_act = k.reshape(B, n_tiles, BS, H, dk)[:, active_tgt]
    s = (torch.einsum("bashd,bathd->bahst", q_act, k_act) * (1.0 / math.sqrt(dk))
         + bias_t[None])
    col_max = s.amax(dim=3)                                         # (B, A, H, BS)
    mx = torch.full((B, n_tiles, H, BS), -math.inf, dtype=s.dtype, device=s.device)
    mx.scatter_reduce_(1, active_tgt.long().view(1, -1, 1, 1).expand_as(col_max), col_max,
                       "amax")
    e = torch.exp(s - mx[:, active_tgt].unsqueeze(3))
    den = torch.zeros_like(mx).index_add_(1, active_tgt, e.sum(dim=3))
    att = e * (1.0 / den.clamp_min(1e-30))[:, active_tgt].unsqueeze(3)
    return q_act, k_act, att


@debug.kernel("bell_fused")
def bell_forward_plain(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas):
    """The fused forward in tensor ops: (B, Np, Co·T) in x's dtype."""
    B, Np, M = x.shape
    H, C, Co = thetas.shape
    T = M // C
    NJ, BS = tile_start.shape[0], bias_t.shape[-1]
    a_tgt, active_src = _tgt_of(tile_start, tile_count), active_src.long()
    _, _, att = active_softmax(q, k, bias_t, active_src, a_tgt, NJ)
    w = (cheb_t[None] * att).to(x.dtype)
    x_src = x.reshape(B, -1, BS, M)[:, active_src].float()          # (B, A, BS, M)
    agg = torch.zeros((B, NJ, H, BS, M), dtype=torch.float32, device=x.device)
    agg.index_add_(1, a_tgt, torch.einsum("bahst,basm->bahtm", w.float(), x_src))
    out = torch.einsum("bjhvct,hco->bjvot", agg.reshape(B, NJ, H, BS, C, T), thetas)
    return torch.relu(out).reshape(B, NJ * BS, Co * T).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

# the SpMM/mix pass on the tensor cores (csrc/bell_fused.cu
# f_spmm_wmma_kernel) shares the backward's chunks of 8 time steps, 8 warps
# and their 16x16 float32 staging (bell_bwd): TN = 16·RF target columns a
# block, warp tiles of RF x CW fragments (RF·CW ≤ 8, CW ≤ 4) for each of the
# HG heads that share a stage (HG·RF·CW ≤ 16, 8 in float32: its split
# operands' fragments), two stages
_TT16, _SMEM_MAX, _pad16 = bell_bwd._TT16, bell_bwd._SMEM_MAX, bell_bwd._pad16
_cdiv, _SCRATCH = bell_bwd._cdiv, bell_bwd._SCRATCH
# (heads a stage, source rows a stage), in the plan's order
_F_STAGES = ((2, 32), (1, 32), (2, 16), (1, 16))
_QROWS, _WCOLS, _DC = 32, 32, 128  # the weights pass: q rows, target columns, d_k columns


def f_wmma_stage_bytes(P, CC, TN, NT, KC, HG):
    """The stage region of a SpMM/mix block: two stages of P planes of KC
    source rows of x (CC channels) and of HG heads' w tiles (bf16, rows
    padded by 8), which then hold Θ's hi and lo for the mix
    (csrc/bell_fused.cu)."""
    return 2 * 2 * P * KC * (HG * (TN + 8) + _pad16(CC * NT * _TT16) + 8)


def f_wmma_smem_bytes(P, C, H, TN, NT, KC, HG, CC, OCB):
    """Shared memory a block of the SpMM/mix pass requests at TN target
    columns, NT chunks of 8 steps, KC source rows and HG heads a stage, CC
    channels a chunk and OCB output columns, P planes a staged operand (the
    formula of csrc/bell_fused.cu): the warps' staging, the stage region,
    agg's bf16 hi and lo for the HG heads of a chunk, and, where the block
    takes more than one (chunk, head group), its output tile's float32 sums."""
    multi = _cdiv(C, CC) * _cdiv(H, HG) > 1
    return (_SCRATCH + f_wmma_stage_bytes(P, CC, TN, NT, KC, HG)
            + 4 * _pad16(HG * CC) * (TN * NT * _TT16 + 8)
            + (4 * TN * NT * _TT16 * OCB if multi else 0))


def f_weights_smem_bytes(dk):
    """Shared memory a block of the weights pass requests at d_k (staged in
    chunks of at most 128 columns)."""
    dc = min(dk, _DC)
    return 4 * (_QROWS * dc + _QROWS * (_WCOLS + 1) + 4 * _WCOLS
                + (0 if dk == 32 else _WCOLS * (dc | 1)))


def _f_cw(CC, NT):
    """Column tiles a warp holds: the block's pad16(CC·8·NT) columns over 8 warps."""
    CF = _pad16(CC * NT * _TT16) // 16
    return 1 if CF <= 8 else 2 if CF <= 16 else 4


def f_plan(BS, C, Co, T, H, dtype):
    """The forward's launch plan: {"cc": channels a chunk (C itself up to
    64, else 64, 32 or 16), "nt": chunks of 8 steps a block (the fewest
    whose CC·8·nt columns fill the eight warps, evened out over T, or
    fewer), "tn": target columns a block (16 to 128, at most pad16(BS)),
    "hg", "kc": the heads and source rows a stage (_F_STAGES; two heads
    where the warp tiles allow: 16 fragments a warp, 8 in float32), "ocb": output columns a
    block, "smem": bytes}. Of the tiles that fit a block (and whose stage
    region holds Θ's split for 16 output columns), the one with the fewest
    output blocks (each sums agg again), then the fewest (chunk, head
    group) steps, the nt of the rule above, the most target columns, and
    the first of _F_STAGES. Every shape has one."""
    P = bell_bwd._planes(dtype)
    BSp, T8, Cop = _pad16(BS), _cdiv(T, _TT16), _pad16(Co)
    best = None
    for cc in ([C] if C <= 64 else []) + [c for c in (64, 32, 16) if c < C]:
        nt0 = min(_cdiv(16, cc), T8)
        nt0 = _cdiv(T8, _cdiv(T8, nt0))
        for nt in sorted({nt0, max(1, nt0 // 2), 1}, reverse=True):
            cw = _f_cw(cc, nt)
            for tn in (128, 64, 32, 16):
                rf = tn // 16
                if tn > BSp or rf * cw > 8:
                    continue
                for si, (hg, kc) in enumerate(_F_STAGES):
                    if ((hg == 2 and (H < 2 or rf * cw * hg > 16 // P)) or kc > BSp
                            or f_wmma_stage_bytes(P, cc, tn, nt, kc, hg)
                            < 4 * _pad16(hg * cc) * 24):
                        continue
                    steps = _cdiv(C, cc) * _cdiv(H, hg)
                    for ocb in bell_bwd._chunks(Cop) if steps > 1 else (Cop,):
                        smem = f_wmma_smem_bytes(P, C, H, tn, nt, kc, hg, cc, ocb)
                        if smem > _SMEM_MAX:
                            continue
                        key = (_cdiv(Cop, ocb), steps, nt0 - nt, -tn, si)
                        if best is None or key < best[0]:
                            best = (key, {"cc": cc, "nt": nt, "tn": tn, "hg": hg, "kc": kc,
                                          "ocb": ocb, "smem": smem})
                        break
    if best is None:
        raise AssertionError(f"no forward tile at BS={BS}, C={C}, Co={Co}, H={H}")
    return best[1]


# the BELL gate: why the card cannot run the BELL conv's kernels (the
# forward, K1, K2) at a shape, the one shape function they all raise at launch
limit_error = bell_bwd.shape_error


def _check(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas):
    if q.ndim != 4 or k.shape != q.shape:
        raise ValueError(f"q and k must be (B, Np, H, d_k), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, Np, H, dk = q.shape
    if bias_t.ndim != 4 or bias_t.shape[1] != H or cheb_t.shape != bias_t.shape:
        raise ValueError(f"bias and cheb tiles must be (A, H={H}, BS, BS), got "
                         f"{tuple(bias_t.shape)}, {tuple(cheb_t.shape)}")
    A, _, BS, _ = bias_t.shape
    if Np % BS:
        raise ValueError(f"the BELL kernel takes a block_size dividing Np, got BS={BS}, "
                         f"Np={Np}")
    if thetas.ndim != 3 or thetas.shape[0] != H:
        raise ValueError(f"thetas must be (H={H}, C, Co), got {tuple(thetas.shape)}")
    C = thetas.shape[1]
    if x.ndim != 3 or tuple(x.shape[:2]) != (B, Np) or x.shape[2] % C:
        raise ValueError(f"x must be (B={B}, Np={Np}, C·T), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the BELL kernel takes float32 or bfloat16 x, got {x.dtype}")
    for name, t in (("q", q), ("k", k), ("bias", bias_t), ("cheb", cheb_t),
                    ("thetas", thetas)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count),
                    ("active_src", active_src)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count),
                    ("active_src", active_src), ("q", q), ("k", k), ("bias", bias_t),
                    ("cheb", cheb_t), ("x", x), ("thetas", thetas)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the BELL kernel runs on CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    why = bell_bwd.shape_error(B, H, C, thetas.shape[2], x.dtype)
    if why is not None:
        raise ValueError(why)


def _load():
    lib = build.load("bell_fused")
    fn = lib.bell_fused_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 18
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.bell_fused_wmma_smem_bytes.argtypes = [ctypes.c_int] * 10
        lib.bell_fused_wmma_smem_bytes.restype = ctypes.c_size_t
        lib.bell_fused_error_string.argtypes = [ctypes.c_int]
        lib.bell_fused_error_string.restype = ctypes.c_char_p
    return lib


@debug.kernel("bell_fused")
def bell_forward_cuda(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas):
    """Launch the fused forward on the current stream, in either dtype."""
    global launches
    _check(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas)
    B, Np, H, dk = q.shape
    A, _, BS, _ = bias_t.shape
    _, C, Co = thetas.shape
    T = x.shape[2] // C
    NJ = tile_start.shape[0]
    plan = f_plan(BS, C, Co, T, H, x.dtype)
    blocks = (NJ * _cdiv(_pad16(Co), plan["ocb"]) * _cdiv(BS, plan["tn"])
              * _cdiv(T, plan["nt"] * _TT16))
    if max(blocks, NJ * _cdiv(BS, _WCOLS)) > bell_bwd._INT_MAX:
        raise ValueError(f"the BELL forward: grid too large ({blocks} blocks)")
    out = torch.empty((B, Np, Co * T), dtype=x.dtype, device=x.device)
    w = torch.empty((B, A, H, BS, BS), dtype=x.dtype, device=x.device)  # scratch
    ptrs = [t.data_ptr() for t in (tile_start, tile_count, active_src, q, k, bias_t, cheb_t,
                                   w, x, thetas)]
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bell_fused_forward(
            *ptrs, out.data_ptr(), B, A, H, NJ, BS, dk, C, T, Co,
            int(x.dtype == torch.float32), plan["tn"], plan["nt"], plan["kc"], plan["hg"],
            plan["cc"], plan["ocb"], int(T % _TT16 == 0 and bell_bwd._aligned(x, out)),
            int(BS % 8 == 0 and bell_bwd._aligned(w)), 1.0 / math.sqrt(dk), stream)
    if err != 0:
        msg = lib.bell_fused_error_string(err).decode()
        raise RuntimeError(f"bell_fused kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def bell_forward(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return bell_forward_plain(tile_start, tile_count, active_src, q, k, bias_t,
                                  cheb_t, x, thetas)
    return bell_forward_cuda(tile_start, tile_count, active_src, q, k, bias_t,
                             cheb_t, x, thetas)


# ---------------------------------------------------------------------------
# differentiable wrapper
# ---------------------------------------------------------------------------

def _forward(bell: BlockEllGraph, q, k, bias_t, cheb_t, x, thetas):
    t = bell.tensors
    return bell_forward(t["tile_start"], t["tile_count"], t["active_src"],
                        q, k, bias_t, cheb_t, x, thetas)


def _backward(bell: BlockEllGraph, q, k, bias_t, cheb_t, pattern_t, x, thetas, out, g):
    """(dq, dk, dbias tiles, dx, dΘ) of the fused conv."""
    t = bell.tensors
    a_src, a_tgt = t["active_src"], t["active_tgt"]
    NJ = bell.num_tiles
    B, Np, H, dk = q.shape
    BS = bias_t.shape[-1]
    gm = g.float() * (out > 0)
    q_act, k_act, att = active_softmax(q, k, bias_t, a_src, a_tgt, NJ)
    att = att * pattern_t[None, :, None]
    w = (att * cheb_t[None]).to(x.dtype)
    gm_k = gm.to(x.dtype)
    dA, dth = bell_bwd.bell_k1(a_src, a_tgt, t["tile_start"], t["tile_count"],
                               thetas, gm_k, x, w)
    dx = bell_bwd.bell_k2(t["src_start"], t["src_count"], t["src_order"],
                          a_tgt, thetas, gm_k, w).to(x.dtype)
    # softmax backward per target column over its whole neighbourhood
    datt = cheb_t[None] * dA
    dot = torch.zeros((B, NJ, H, BS), dtype=torch.float32, device=q.device)
    dot.index_add_(1, a_tgt, (att * datt).sum(dim=3))
    ds = att * (datt - dot[:, a_tgt].unsqueeze(3))
    inv = 1.0 / math.sqrt(dk)
    dq = torch.zeros((B, Np // BS, BS, H, dk), dtype=torch.float32, device=q.device)
    dq.index_add_(1, a_src, torch.einsum("bahst,bathd->bashd", ds, k_act) * inv)
    dk_ = torch.zeros((B, NJ, BS, H, dk), dtype=torch.float32, device=q.device)
    dk_.index_add_(1, a_tgt, torch.einsum("bahst,bashd->bathd", ds, q_act) * inv)
    return (dq.reshape(q.shape), dk_.reshape(k.shape), ds.sum(dim=0), dx, dth)


def _plane_tiles(plane, bell: BlockEllGraph):
    """(H, Np, Np) (source, target) plane → (A, H, BS, BS) active tiles."""
    H, Np, _ = plane.shape
    BS, NJ = bell.block_size, bell.num_tiles
    p5 = plane.reshape(H, Np // BS, BS, NJ, BS).permute(1, 3, 0, 2, 4)
    return p5[bell.tensors["active_src"], bell.tensors["active_tgt"]].contiguous()


class BellTilesOut(torch.autograd.Function):
    """relu(Σ_h aggregation_h · Θ_h) with bias and Chebyshev values as
    active-list tiles (A, H, BS, BS), the bias folded to −1e30 off-pattern.
    Gradients for q, k, the bias tiles, x and Θ."""

    @staticmethod
    def forward(ctx, q, k, bias_t, cheb_t, x, thetas, bell, pattern_t):
        out = _forward(bell, q, k, bias_t, cheb_t, x, thetas)
        ctx.bell = bell
        ctx.save_for_backward(q, k, bias_t, cheb_t, pattern_t, x, thetas, out)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dbias, dx, dth = _backward(ctx.bell, *ctx.saved_tensors, g)
        return dq, dk, dbias, None, dx, dth, None, None


# ---------------------------------------------------------------------------
# model-facing functions
# ---------------------------------------------------------------------------

def _require_lists(bell: BlockEllGraph, who: str) -> None:
    if bell.active_src is None or bell.tile_start is None or bell.src_order is None:
        raise ValueError(f"{who} needs the active-tile lists; build the graph with "
                         "block_ell_from_adjacency().")
    if not bell.covered:
        raise ValueError("the fused BELL kernel requires every target column to have "
                         "at least one in-edge (use include_self=True).")


def _qk(emb, wq, wk, bell, n_heads, d_k):
    B, N, _ = emb.shape
    q = torch.einsum("bnd,dh->bnh", emb, wq).float().reshape(B, N, n_heads, d_k)
    k = torch.einsum("bnd,dh->bnh", emb, wk).float().reshape(B, N, n_heads, d_k)
    return (pad_node_axis(q, bell, 1).contiguous(),
            pad_node_axis(k, bell, 1).contiguous())


def bell_cheb_conv_with_sat_pallas(
    x: torch.Tensor,
    emb: torch.Tensor,
    bell: BlockEllGraph,
    *,
    wq: torch.Tensor,
    wk: torch.Tensor,
    adj_pa: torch.Tensor,
    masks: torch.Tensor,
    cheb_polys: torch.Tensor,
    thetas: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """Drop-in for the plain BELL path (block scores + conv) through the
    fused kernel, with dense (K, N, N) masks. x (B, N, C, T), emb (B, N,
    d_model) → (B, N, C_out, T) in x's dtype, ReLU applied. The name keeps
    the JAX package's ``use_pallas`` knob."""
    _require_lists(bell, "bell_cheb_conv_with_sat_pallas")
    B, N, C, T = x.shape
    Co = thetas.shape[-1]
    q, k = _qk(emb, wq, wk, bell, n_heads, d_k)
    pad2 = lambda a: pad_node_axis(pad_node_axis(a, bell, 1), bell, 2)
    pattern = bell.tensors["active_pattern"]
    # the planes cut to the active tiles (autograd scatters the bias
    # gradient back), the edge pattern folded in: −1e30 off-pattern
    bias_t = _plane_tiles(pad2((adj_pa[None] * masks).float()), bell)
    bias_t = torch.where(pattern[:, None], bias_t, _NEG)
    cheb_t = _plane_tiles(pad2(cheb_polys.float()), bell)
    xm = pad_node_axis(x.reshape(B, N, C * T), bell, 1).contiguous()
    out = BellTilesOut.apply(q, k, bias_t.contiguous(), cheb_t, xm,
                             thetas.float().contiguous(), bell, pattern)
    return out[:, :N].reshape(B, N, Co, T).to(x.dtype)


def bell_cheb_conv_tiles(
    x: torch.Tensor,
    emb: torch.Tensor,
    bell: BlockEllGraph,
    *,
    wq: torch.Tensor,
    wk: torch.Tensor,
    mask_tiles: torch.Tensor,
    pattern_tiles: torch.Tensor,
    pa_tiles: torch.Tensor,
    cheb_tiles: torch.Tensor,
    thetas: torch.Tensor,
    n_heads: int,
    d_k: int,
) -> torch.Tensor:
    """Tile-resident BELL spatial conv: the learnable masks live only on the
    active-tile support (``mask_tiles`` (A, K, BS, BS)) and adj_pa / T_k
    arrive as per-tile constants (``ops.block_sparse.
    build_bell_tile_constants``), so nothing O(N²) is built. Same function
    as :func:`bell_cheb_conv_with_sat_pallas` on those values."""
    _require_lists(bell, "bell_cheb_conv_tiles")
    B, N, C, T = x.shape
    Co = thetas.shape[-1]
    q, k = _qk(emb, wq, wk, bell, n_heads, d_k)
    # bias = adj_pa ⊙ mask on the pattern, −1e30 elsewhere; the where also
    # zeroes the off-pattern mask gradients
    bias_t = torch.where(pattern_tiles[:, None], (pa_tiles[:, None] * mask_tiles).float(), _NEG)
    xm = pad_node_axis(x.reshape(B, N, C * T), bell, 1).contiguous()
    out = BellTilesOut.apply(q, k, bias_t.contiguous(), cheb_tiles.float().contiguous(),
                             xm, thetas.float().contiguous(), bell, pattern_tiles)
    return out[:, :N].reshape(B, N, Co, T).to(x.dtype)
