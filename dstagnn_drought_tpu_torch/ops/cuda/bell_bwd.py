"""Backward kernels of the fused BELL conv — K1 (dA, dΘ) and K2 (dx) — and
their plain PyTorch versions.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/bell_bwd.py``
(``bell_bwd_dA_dtheta`` and ``bell_bwd_dx``, both TPU layouts) in the one
c-major layout of the port: x is (B, Np, C·T), the cotangent ``gm`` (the
output gradient times the ReLU mask, in x's dtype) is (B, Np, Co·T), the
modulated weights ``w = T_k ⊙ softmax`` are (B, A, H, BS_src, BS_tgt) in
x's dtype, one tile per entry of the target-sorted active list. With
g_agg_h = gm · Θ_hᵀ (per target row, (Co → C) at every time step):

    K1:  dA[b,a,h] = x[src(a)] · round(g_agg_h[tgt(a)])ᵀ       (f32)
         dΘ_h      = Σ_{b,a} (w[b,a,h]ᵀ · x[src(a)])ᵀ · gm[tgt(a)]
    K2:  dx[i]     = Σ_{a: src(a)=i} Σ_h w[b,a,h] · g_agg_h[tgt(a)]

``round`` is the cast to x's dtype that the TPU kernel applies before its
dA product, once, after the whole sum over Co; K2 keeps g_agg in float32 as
the TPU kernel does. The kernels (``csrc/bell_bwd.cu``; its header says
what bounds them) recompute g_agg from gm and Θ in shared memory, so the
(B, H, Np, C·T) tensor never reaches device memory; dΘ is summed from
per-block partials by a second pass in a fixed order (no atomics: two runs
give the same bits); K2 walks the source-sorted list so every block owns
its dx tile (no scatter).

One design for both dtypes, every product on the tensor cores (WMMA) in
chunks of 8 time steps: bf16 operands as they are, float32 ones split into
bf16 hi + lo (three products where two float32 values meet), Θ, agg and
g_agg split where they meet a float32 sum, so dΘ, g_agg and K2's dx stay
float32 in value. Channels, output channels and rows come in chunks
(:func:`k1_plan` and :func:`k2_plan` size them), so every C, Co and block
size runs; :func:`shape_error` says what the kernels refuse (only the
dtype, CUDA's grid limits and an int32 guard). On a CUDA
tensor the wrappers launch the kernels or raise; the plain versions serve
CPU tensors only. ``k1_launches``/``k2_launches`` count launches.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.cuda import build

k1_launches = 0
k2_launches = 0

# chunks of 8 time steps (one 16-byte bf16 row segment), tiles padded to
# 16, each warp's 16x16 float32 staging at a row stride of 20; a block may
# have 232,448 bytes, two blocks an SM 115,712 each (228 KiB an SM, 1 KiB of
# it reserved a block)
_TT16, _WARPS, _STAGE = 8, 8, 16 * 20
_SMEM_MAX, _SMEM_TWO = 232448, 115712
_SCRATCH = 4 * _WARPS * _STAGE
# CUDA's limit on a grid's y and z, and the largest int the kernels index with
_GRID_YZ, _INT_MAX = 65535, 2**31 - 1
# the float32 bytes that the dΘ partials may take before time groups fold
# into one block (k1_time_groups)
_PARTIAL_BUDGET = 16 * 2**20
_DTYPES = (torch.float32, torch.bfloat16)


def _pad16(n):
    return (n + 15) // 16 * 16


def _cdiv(a, b):
    return -(-a // b)


def _planes(dtype):
    """Planes a staged operand takes: float32 two (bf16 hi and lo), bf16 one."""
    return 2 if dtype == torch.float32 else 1


def _chunks(n, sizes=(512, 256, 128, 64, 32, 16)):
    """n itself, then the chunk sizes below it."""
    return [n] + [s for s in sizes if s < n]


def shape_error(B, H, C, Co, dtype):
    """Why the BELL kernels (the forward, K1 and K2) cannot take this shape
    on the card, or None: the compute dtype, CUDA's grid limits on B, H and
    B·H (grid y and z) and the int32 index of a (H, C, Co) dΘ row. The
    block size, d_k and T come in chunks and are refused by none of them.
    Every wrapper raises it at launch, and the Trainer's gate
    (``bell_fused.limit_error``) is this function."""
    who = "the BELL kernels"
    if dtype not in _DTYPES:
        return f"{who} take float32 or bfloat16, got {dtype}"
    if max(B, H, B * H) > _GRID_YZ:
        return f"{who}: grid too large for B={B}, H={H} (B·H <= {_GRID_YZ})"
    if H * _pad16(C) * _pad16(Co) * 16 > _INT_MAX:
        return f"{who}: H·C·Co = {H}·{C}·{Co} is past the kernels' int32 indices"
    return None


# ---------------------------------------------------------------------------
# K1's plan (csrc/bell_bwd.cu k1_dA_wmma_kernel, k1_dtheta_wmma_kernel)
# ---------------------------------------------------------------------------

def k1_dtheta_cc(C):
    """Channels an m-tile of the dΘ pass takes: a power of two ≤ 16."""
    cc = 16
    while cc > C:
        cc //= 2
    return cc


def k1_smem_bytes(P, BS, C, Co, tiles, pass_):
    """Shared memory a block of K1's dA pass (``pass_`` 0, ``tiles`` = (TN
    target columns, RS source rows, CC channels, OCC output channels)) or
    dΘ pass (1, (TC target rows a contraction chunk, KS source rows a
    stage, OCB output columns, WO o-lanes)) requests at P planes a staged
    operand (the formulas of csrc/bell_bwd.cu)."""
    if pass_ == 0:
        tn, rs, cc, occ = tiles
        ldx, ldg, occp = _pad16(cc * _TT16) + 8, tn * _TT16 + 8, _pad16(occ)
        xr = max(P * rs * ldx, 2 * tn * _TT16 * _pad16(cc) if _cdiv(Co, occ) > 1 else 0)
        return _SCRATCH + 2 * (xr + P * tn * ldx + P * occp * ldg + 2 * _pad16(cc) * (occp + 8))
    tc, ks, ocb, wo = tiles
    ldw, ldm = min(_pad16(BS), 128) + 8, _pad16(k1_dtheta_cc(C) * _TT16) + 8
    region = max(2 * P * ks * (ldw + ldm), 4 * (_WARPS // wo) * 16 * ocb, _SCRATCH)
    ld = tc * _TT16 + 8
    return region + 2 * (2 * 16 * ld + P * ocb * ld)


def _k1_dA_tiles(BS, C, Co, P):
    """(TN, RS, CC, OCC) of the dA pass: of the tiles that fit a block, the
    least staging (x once per TN-column tile, gm once per time chunk where
    one chunk holds Co, else once per channel chunk), then the most target
    columns, channels and output channels."""
    BSp = _pad16(BS)
    rs, best = min(BSp, 128), None
    for occ in _chunks(Co):
        for tn in (t for t in (128, 64, 32, 16) if t <= BSp):
            for cc in [C] + [c for c in (64, 32, 16) if c < C]:
                if k1_smem_bytes(P, BS, C, Co, (tn, rs, cc, occ), 0) > _SMEM_MAX:
                    continue
                n_cc = _cdiv(C, cc) if _cdiv(Co, occ) > 1 else 1
                key = (_cdiv(BSp, tn) * C + n_cc * Co, -tn, -cc, -occ)
                if best is None or key < best[0]:
                    best = (key, (tn, rs, cc, occ))
    return best[1]


def _k1_dtheta_tiles(BS, C, Co, P):
    """(TC, KS, OCB, WO) of the dΘ pass: the most output columns a block (at
    most 512: agg is summed again for every output block), two bf16 blocks
    an SM where a tile allows it, the most source rows a stage, then the
    most target rows a contraction chunk dividing the target-row tile; WO
    o-lanes so that a warp holds at most 4 partial fragments."""
    BSp = _pad16(BS)
    trr = min(BSp, 128)
    tcs = [t for t in range(trr, 15, -16) if trr % t == 0]
    limits = (_SMEM_TWO, _SMEM_MAX) if P == 1 else (_SMEM_MAX,)
    for ocb in _chunks(min(_pad16(Co), 512)):
        of = ocb // 16
        wo = next(w for w in (1, 2, 4, 8) if _cdiv(of, w) <= 4)
        for limit in limits:
            for ks in (k for k in (128, 64, 32, 16) if k <= trr):
                for tc in tcs:
                    if k1_smem_bytes(P, BS, C, Co, (tc, ks, ocb, wo), 1) <= limit:
                        return tc, ks, ocb, wo
    raise AssertionError(f"no dΘ tile at BS={BS}, C={C}, Co={Co}")  # 16-row tiles always fit


def k1_plan(BS, C, Co, T, dtype):
    """K1's launch plan: {"tn", "rs", "cc", "occ": the dA pass's target
    columns, source rows, channels and output channels a block or chunk;
    "tc", "ks", "ocb", "wo": the dΘ pass's target rows a contraction chunk,
    source rows a stage, output columns a block and o-lanes; "smem": (dA
    bytes, dΘ bytes)}. Every shape has one."""
    P = _planes(dtype)
    tn, rs, cc, occ = _k1_dA_tiles(BS, C, Co, P)
    tc, ks, ocb, wo = _k1_dtheta_tiles(BS, C, Co, P)
    return {"tn": tn, "rs": rs, "cc": cc, "occ": occ, "tc": tc, "ks": ks, "ocb": ocb, "wo": wo,
            "smem": (k1_smem_bytes(P, BS, C, Co, (tn, rs, cc, occ), 0),
                     k1_smem_bytes(P, BS, C, Co, (tc, ks, ocb, wo), 1))}


def k1_time_groups(B, NJ, BS, H, C, Co, T):
    """(G, TG): the dΘ pass's time groups and chunks of 8 steps a group.
    Each group writes one float32 partial of H·C·Co per (batch, target
    tile, target-row tile); groups fold as many chunks as keep the
    partials within 16 MiB (or one group)."""
    T8 = _cdiv(T, _TT16)
    unit = 4 * B * NJ * _cdiv(_pad16(BS), 128) * H * C * Co
    g = max(1, min(T8, _PARTIAL_BUDGET // max(unit, 1)))
    tg = _cdiv(T8, g)
    return _cdiv(T8, tg), tg


# ---------------------------------------------------------------------------
# K2's plan (csrc/bell_bwd.cu k2_wmma_kernel): a block per (group of min(C,
# 16) channels x nt chunks of 8 steps, <= 128 source rows, source tile,
# batch) with a dx tile of at most 128 rows x pad16(nt·CG·8) ≤ 128 columns;
# a step stages tr target rows of gm (every head where one chunk holds Co),
# w_h's tr columns and Θ_h's split (rows of 16 channels at a stride of 24)
# for occ output channels; nt and tr are powers of two
# ---------------------------------------------------------------------------

_K2_LDT = 24


def _k2_cg(C):
    """Channels a K2 block takes."""
    return min(C, 16)


def k2_smem_bytes(P, BS, C, Co, nt, tr, occ):
    """Shared memory a K2 block requests at nt chunks of 8 steps, tr target
    rows a step and occ output channels a chunk, P planes a staged operand
    (the formula of csrc/bell_bwd.cu): the warps' staging, the step's stage
    (gm rows, w columns, Θ's hi and lo), g's hi and lo, and g's float32
    sums where Co takes more than one chunk."""
    occp, rs = _pad16(occ), min(_pad16(BS), 128)
    multi = _cdiv(_pad16(Co), occp) > 1
    return _SCRATCH + 2 * (
        P * occp * (nt * tr * _TT16 + 8) + P * rs * (tr + 8) + 2 * occp * _K2_LDT
        + 2 * tr * (_pad16(nt * _k2_cg(C) * _TT16) + 8)) + (
        4 * nt * tr * _TT16 * 16 if multi else 0)


def k2_plan(BS, C, Co, T, dtype):
    """K2's launch plan: {"occ": output channels a chunk (all of Co where
    they fit), "nt": chunks of 8 steps a block (the most power of two whose
    columns of min(C, 16) channels fit 128, at most the steps), "tr":
    target rows a step (the most power of two dividing pad16(BS) with which
    two bf16 blocks share an SM, else the most that fits; fewer chunks where
    none fits), "groups": (channel groups, time groups) of the grid,
    "smem": bytes}. Every shape has one: 16 target rows of one chunk of 16
    output channels fit at any C and BS."""
    P, BSp, T8, CG = _planes(dtype), _pad16(BS), _cdiv(T, _TT16), _k2_cg(C)
    nts = [2 ** k for k in reversed(range(min(16 // CG, T8).bit_length()))]
    trs = [t for t in (128, 64, 32, 16) if BSp % t == 0]
    limits = (_SMEM_TWO, _SMEM_MAX) if P == 1 else (_SMEM_MAX,)
    for occ in _chunks(_pad16(Co)):
        for nt in nts:
            for limit in limits:
                for tr in trs:
                    smem = k2_smem_bytes(P, BS, C, Co, nt, tr, occ)
                    if smem <= limit:
                        return {"occ": occ, "nt": nt, "tr": tr,
                                "groups": (_cdiv(C, CG), _cdiv(T8, nt)), "smem": smem}
    raise AssertionError(f"no K2 tile at BS={BS}, C={C}, Co={Co}")  # 16 x 16 always fits


def _g_agg(gm, thetas, T):
    """g_agg (B, Np, H, C·T) float32 from gm (B, Np, Co·T) and Θ (H, C, Co)."""
    B, Np, _ = gm.shape
    H, C, Co = thetas.shape
    g = torch.einsum("bnot,hco->bnhct", gm.float().reshape(B, Np, Co, T), thetas.float())
    return g.reshape(B, Np, H, C * T)


@debug.kernel("bell_k1")
def bell_k1_plain(active_src, active_tgt, thetas, gm, x, w):
    """K1 in tensor ops: (dA (B, A, H, BS, BS) f32, dΘ (H, C, Co) f32)."""
    B, A, H, BS, _ = w.shape
    M = x.shape[-1]
    _, C, Co = thetas.shape
    T = M // C
    active_src, active_tgt = active_src.long(), active_tgt.long()
    g = _g_agg(gm, thetas, T).to(x.dtype).float()            # rounded like x
    g = g.reshape(B, -1, BS, H, M)[:, active_tgt]            # (B, A, BS_t, H, M)
    x_src = x.reshape(B, -1, BS, M)[:, active_src].float()   # (B, A, BS_s, M)
    dA = torch.einsum("basm,bathm->bahst", x_src, g)
    agg = torch.einsum("bahst,basm->bahtm", w.float(), x_src)
    gm_t = gm.float().reshape(B, -1, BS, Co, T)[:, active_tgt]
    dth = torch.einsum("bahvct,bavot->hco", agg.reshape(B, A, H, BS, C, T), gm_t)
    return dA, dth


@debug.kernel("bell_k2")
def bell_k2_plain(src_start, src_count, src_order, active_tgt, thetas, gm, w):
    """K2 in tensor ops: dx (B, NI·BS, C·T) in gm's dtype."""
    B, A, H, BS, _ = w.shape
    _, C, Co = thetas.shape
    T = gm.shape[-1] // Co
    NI = src_count.shape[0]
    active_tgt = active_tgt.long()
    a_src = torch.empty(A, dtype=torch.long, device=w.device)
    a_src[src_order.long()] = torch.repeat_interleave(
        torch.arange(NI, device=w.device), src_count.long())
    g = _g_agg(gm, thetas, T).reshape(B, -1, BS, H, C * T)[:, active_tgt]
    dx_t = torch.einsum("bahst,bathm->basm", w.float(), g)
    dx = torch.zeros((B, NI, BS, C * T), dtype=torch.float32, device=gm.device)
    dx.index_add_(1, a_src, dx_t)
    return dx.reshape(B, NI * BS, C * T).to(gm.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check(thetas, gm, w, indices, others=()):
    if w.ndim != 5 or w.shape[3] != w.shape[4]:
        raise ValueError(f"w must be (B, A, H, BS, BS), got {tuple(w.shape)}")
    B, A, H, BS, _ = w.shape
    if thetas.ndim != 3 or thetas.shape[0] != H or thetas.dtype != torch.float32:
        raise ValueError(f"thetas must be float32 (H={H}, C, Co), got "
                         f"{thetas.dtype} {tuple(thetas.shape)}")
    Co = thetas.shape[2]
    if gm.ndim != 3 or gm.shape[0] != B or gm.shape[1] % BS or gm.shape[2] % Co:
        raise ValueError(f"gm must be (B={B}, NJ·BS, Co·T), got {tuple(gm.shape)}")
    if gm.dtype not in _DTYPES or w.dtype != gm.dtype:
        raise TypeError(f"gm and w must share float32 or bfloat16, got {gm.dtype}, {w.dtype}")
    for name, t in (("thetas", thetas), ("gm", gm), ("w", w), *others, *indices):
        if t.device.type != "cuda" or t.device != w.device:
            raise ValueError(f"the BELL kernels run on CUDA tensors; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in indices:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")


def _grid_x(n, who):
    if n > _INT_MAX:
        raise ValueError(f"{who}: grid too large ({n} blocks)")


def _load():
    lib = build.load("bell_bwd")
    if lib.bell_bwd_k1.argtypes is None:
        lib.bell_bwd_k1.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 21 + [ctypes.c_void_p]
        lib.bell_bwd_k1.restype = ctypes.c_int
        lib.bell_bwd_k1_wmma_smem_bytes.argtypes = [ctypes.c_int] * 9
        lib.bell_bwd_k1_wmma_smem_bytes.restype = ctypes.c_size_t
        lib.bell_bwd_k2.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        lib.bell_bwd_k2.restype = ctypes.c_int
        lib.bell_bwd_k2_wmma_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.bell_bwd_k2_wmma_smem_bytes.restype = ctypes.c_size_t
        lib.bell_bwd_error_string.argtypes = [ctypes.c_int]
        lib.bell_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.bell_bwd_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


@debug.kernel("bell_k1")
def bell_k1_cuda(active_src, active_tgt, tile_start, tile_count, thetas, gm, x, w):
    """Launch K1 on the current stream: (dA f32, dΘ f32), in either dtype."""
    global k1_launches
    _check(thetas, gm, w, (("active_src", active_src), ("active_tgt", active_tgt),
                           ("tile_start", tile_start), ("tile_count", tile_count)),
           (("x", x),))
    B, A, H, BS, _ = w.shape
    _, C, Co = thetas.shape
    M = x.shape[-1]
    if x.dtype != w.dtype or x.shape[0] != B or x.shape[1] % BS or M % C:
        raise ValueError(f"x must be (B, NI·BS, C·T) in {w.dtype}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    T = M // C
    if gm.shape[2] != Co * T:
        raise ValueError(f"gm has {gm.shape[2]} features, expected Co·T={Co * T}")
    why = shape_error(B, H, C, Co, x.dtype)
    if why is not None:
        raise ValueError(why)
    NJ = tile_start.shape[0]
    p = k1_plan(BS, C, Co, T, x.dtype)
    G, TG = k1_time_groups(B, NJ, BS, H, C, Co, T)
    n_tr = _cdiv(_pad16(BS), 128)
    _grid_x(A * _cdiv(BS, p["tn"]) * _cdiv(BS, p["rs"]), "the BELL K1 dA pass")
    _grid_x(NJ * _cdiv(C, k1_dtheta_cc(C)) * _cdiv(_pad16(Co), p["ocb"]) * n_tr * G,
            "the BELL K1 dΘ pass")
    dev = w.device
    dA = torch.empty((B, A, H, BS, BS), dtype=torch.float32, device=dev)
    # the dΘ partials, then the fixed-order row sums' groups of 64
    S = B * NJ * n_tr * G
    partial = torch.empty(((S + _cdiv(S, 64)) * H, C * Co), dtype=torch.float32, device=dev)
    dth = torch.empty((H, C, Co), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (active_src, active_tgt, tile_start, tile_count, thetas,
                                   gm, x, w, dA, partial, dth)]
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bell_bwd_k1(
            *ptrs, B, A, H, NJ, BS, C, T, Co, int(x.dtype == torch.float32), p["tn"], p["rs"],
            p["cc"], p["occ"], p["tc"], p["ks"], p["ocb"], p["wo"], G, TG,
            int(T % _TT16 == 0 and _aligned(gm, x)), int(BS % 8 == 0 and _aligned(w)), stream)
    _raise_on(lib, err, "bell_bwd K1")
    k1_launches += 1
    return dA, dth


@debug.kernel("bell_k2")
def bell_k2_cuda(src_start, src_count, src_order, active_tgt, thetas, gm, w):
    """Launch K2 on the current stream: dx (B, NI·BS, C·T) in gm's dtype."""
    global k2_launches
    _check(thetas, gm, w, (("src_start", src_start), ("src_count", src_count),
                           ("src_order", src_order), ("active_tgt", active_tgt)))
    B, A, H, BS, _ = w.shape
    _, C, Co = thetas.shape
    T = gm.shape[-1] // Co
    why = shape_error(B, H, C, Co, gm.dtype)
    if why is not None:
        raise ValueError(why)
    NI, NJ = src_start.shape[0], gm.shape[1] // BS
    p = k2_plan(BS, C, Co, T, gm.dtype)
    n_cg, n_tg = p["groups"]
    _grid_x(NI * n_tg * _cdiv(_pad16(BS), 128) * n_cg, "the BELL K2 kernel")
    dev = w.device
    dx = torch.empty((B, NI * BS, C * T), dtype=gm.dtype, device=dev)
    split = torch.empty(H * n_cg * 2 * _pad16(Co) * 16, dtype=torch.bfloat16, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bell_bwd_k2(
            *(t.data_ptr() for t in (src_start, src_count, src_order, active_tgt, thetas, split,
                                     gm, w, dx)),
            B, A, H, NI, NJ, BS, C, T, Co, int(gm.dtype == torch.float32), p["nt"], p["tr"],
            p["occ"], int(T % _TT16 == 0 and _aligned(gm, dx)),
            int(BS % 8 == 0 and _aligned(w)), stream)
    _raise_on(lib, err, "bell_bwd K2")
    k2_launches += 1
    return dx


def bell_k1(active_src, active_tgt, tile_start, tile_count, thetas, gm, x, w):
    """K1: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if w.device.type == "cpu":
        return bell_k1_plain(active_src, active_tgt, thetas, gm, x, w)
    return bell_k1_cuda(active_src, active_tgt, tile_start, tile_count, thetas, gm, x, w)


def bell_k2(src_start, src_count, src_order, active_tgt, thetas, gm, w):
    """K2: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if w.device.type == "cpu":
        return bell_k2_plain(src_start, src_count, src_order, active_tgt, thetas, gm, w)
    return bell_k2_cuda(src_start, src_count, src_order, active_tgt, thetas, gm, w)
