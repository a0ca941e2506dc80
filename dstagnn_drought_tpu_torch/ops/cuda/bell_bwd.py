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
dA product; K2 keeps g_agg in float32 as the TPU kernel does. The kernels
(``csrc/bell_bwd.cu``; its header says what bounds them) recompute g_agg
from gm and Θ in shared memory, so the (B, H, Np, C·T) tensor never
reaches device memory; dΘ is summed from per-block partials by a second
pass in a fixed order (no atomics: two runs give the same bits); K2 walks
the source-sorted list so every block owns its dx tile (no scatter).

K1 and K2 have two designs each, one a dtype: bf16 (the BELL-tiles main
path) runs on the tensor cores (WMMA) in chunks of 8 time steps, Θ, agg
and g_agg split into bf16 hi + lo where they meet a float32 sum, so dΘ,
g_agg and K2's dx stay float32 in value (:func:`k1_bf16_plan` and
:func:`k2_bf16_plan` size their tiles); float32 keeps the CUDA-core
kernels and their :func:`time_chunk` plan. On a CUDA tensor the wrappers
launch the design of the dtype or raise; the plain versions serve CPU
tensors only. ``k1_launches``/``k2_launches`` count launches.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.cuda import build

k1_launches = 0
k2_launches = 0

# a kernel block covers a chunk of time steps with every channel of each
# step: at most 64 input columns (C·TT) in a tile of sums, and at most 512
# staged cotangent columns (Co·TT; 128 in K1's dA pass, which stages 64 rows)
_W_MAX, _WO_MAX, _BS_MAX = 64, 512, 128


def time_chunk(C: int, Co: int, T: int, staged: int = _WO_MAX) -> int:
    """Time steps per kernel block: C·TT ≤ 64, Co·TT ≤ ``staged``, TT ≤ T."""
    if C > _W_MAX or Co > staged:
        raise ValueError(f"the BELL kernels take C <= {_W_MAX} and Co <= {staged}, "
                         f"got C={C}, Co={Co}")
    return max(1, min(_W_MAX // C, staged // Co, T))


# the bf16 K1 on the tensor cores (csrc/bell_bwd.cu k1_dA_wmma_kernel,
# k1_dtheta_wmma_kernel): chunks of 8 time steps (one 16-byte bf16 row
# segment), tiles padded to 16, each warp's 16x16 float32 staging at a row
# stride of 20; a block may have 232,448 bytes, two blocks an SM 115,712
# each (228 KiB an SM, 1 KiB of it reserved a block)
_TT16, _WARPS, _STAGE = 8, 8, 16 * 20
_SMEM_MAX, _SMEM_TWO = 232448, 115712


def _pad16(n):
    return (n + 15) // 16 * 16


def _k1_wmma_cc(C):
    """Channels an m-tile of the bf16 dΘ pass takes: a power of two ≤ 16."""
    cc = 16
    while cc > C:
        cc //= 2
    return cc


def k1_wmma_smem_bytes(BS, C, Co, tile, pass_):
    """Shared memory a block of the bf16 K1's dA pass (``pass_`` 0, ``tile``
    target columns) or dΘ pass (1, ``tile`` target rows a contraction
    chunk) requests (the formulas of csrc/bell_bwd.cu)."""
    BSp, Cop = _pad16(BS), _pad16(Co)
    scratch = 4 * _WARPS * _STAGE
    if pass_ == 0:
        ldx, ldg, ldt = _pad16(C * _TT16) + 8, tile * _TT16 + 8, Cop + 8
        return scratch + 2 * ((BSp + tile) * ldx + Cop * ldg + 2 * _pad16(C) * ldt)
    ldw, ldm, ld = BSp + 8, _pad16(_k1_wmma_cc(C) * _TT16) + 8, tile * _TT16 + 8
    region = max(2 * BSp * (ldw + ldm), 4 * _WARPS * 16 * Cop, scratch)
    return region + 2 * (2 * 16 * ld + Cop * ld)


def k1_bf16_plan(BS, C, Co, T):
    """The bf16 K1's launch plan: {"tn": target columns a dA block (the most
    of 128, 64, 32, 16, at most pad16(BS), whose shared memory fits), "tc":
    target rows a dΘ contraction chunk (the most multiple of 16 dividing
    pad16(BS) with which two blocks share an SM, else the most that fits),
    "cc": channels a dΘ m-tile, "groups": dΘ partials per (batch, head,
    target tile) (one per chunk of 8 steps, every channel), "smem": (dA
    bytes, dΘ bytes)}. Raises ValueError outside the kernels' caps (C ≤ 64,
    Co ≤ 128, BS ≤ 128, those of the float32 kernels), where every shape
    fits."""
    if C > _W_MAX or Co > 128 or BS > _BS_MAX:
        raise ValueError(f"the BELL K1 kernels take C <= {_W_MAX}, Co <= 128 and "
                         f"block_size <= {_BS_MAX}, got C={C}, Co={Co}, BS={BS}")
    BSp = _pad16(BS)
    tn = next(t for t in (128, 64, 32, 16)
              if t <= BSp and k1_wmma_smem_bytes(BS, C, Co, t, 0) <= _SMEM_MAX)
    tcs = [t for t in range(BSp, 15, -16) if BSp % t == 0]
    tc = next((t for t in tcs if k1_wmma_smem_bytes(BS, C, Co, t, 1) <= _SMEM_TWO),
              next(t for t in tcs if k1_wmma_smem_bytes(BS, C, Co, t, 1) <= _SMEM_MAX))
    return {"tn": tn, "tc": tc, "cc": _k1_wmma_cc(C), "groups": -(-T // _TT16),
            "smem": (k1_wmma_smem_bytes(BS, C, Co, tn, 0),
                     k1_wmma_smem_bytes(BS, C, Co, tc, 1))}


# the bf16 K2 on the tensor cores (csrc/bell_bwd.cu k2_wmma_kernel): a block
# per (group of min(C, 16) channels x nt chunks of 8 steps, source tile,
# batch) with a dx tile of pad16(BS) rows x pad16(nt·CG·8) ≤ 128 columns;
# a step stages tr target rows of gm (every head), w_h's tr columns and
# Θ_h's split (rows of 16 channels at a stride of 24); nt and tr are powers
# of two
_K2_LDT = 24


def _k2_cg(C):
    """Channels a bf16 K2 block takes."""
    return min(C, 16)


def k2_wmma_smem_bytes(BS, C, Co, nt, tr):
    """Shared memory a block of the bf16 K2 requests at nt chunks of 8
    steps and tr target rows a step (the formula of csrc/bell_bwd.cu): the
    warps' staging, the step's stage (gm rows, w columns, Θ's hi and lo),
    and g's hi and lo."""
    Cop = _pad16(Co)
    return 4 * _WARPS * _STAGE + 2 * (
        Cop * (nt * tr * _TT16 + 8) + _pad16(BS) * (tr + 8) + 2 * Cop * _K2_LDT
        + 2 * tr * (_pad16(nt * _k2_cg(C) * _TT16) + 8))


def k2_bf16_plan(BS, C, Co, T):
    """The bf16 K2's launch plan: {"nt": chunks of 8 steps a block (the most
    power of two whose columns of min(C, 16) channels fit 128, at most the
    steps), "tr": target rows a step (the most power of two dividing
    pad16(BS) with which two blocks share an SM, else the most that fits;
    fewer chunks where none fits), "groups": (channel groups, time groups)
    of the grid, "smem": bytes}. Raises ValueError exactly where the
    float32 K2 refuses (C ≤ 64, Co ≤ 512, BS ≤ 128); every shape inside
    fits (16 target rows of one chunk at Co = 512 take 213,504 bytes)."""
    time_chunk(C, Co, T)
    if BS > _BS_MAX:
        raise ValueError(f"the BELL kernels take block_size <= {_BS_MAX}, got {BS}")
    BSp, T8, CG = _pad16(BS), -(-T // _TT16), _k2_cg(C)
    nts = [2 ** k for k in reversed(range(min(16 // CG, T8).bit_length()))]
    trs = [t for t in (128, 64, 32, 16) if BSp % t == 0]
    for nt in nts:
        for limit in (_SMEM_TWO, _SMEM_MAX):
            for tr in trs:
                smem = k2_wmma_smem_bytes(BS, C, Co, nt, tr)
                if smem <= limit:
                    return {"nt": nt, "tr": tr, "groups": (-(-C // CG), -(-T8 // nt)),
                            "smem": smem}
    raise ValueError(f"the bf16 BELL K2 does not fit a block at BS={BS}, C={C}, Co={Co}")


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

_DTYPES = (torch.float32, torch.bfloat16)


def _check(thetas, gm, w, indices, others=()):
    if w.ndim != 5 or w.shape[3] != w.shape[4]:
        raise ValueError(f"w must be (B, A, H, BS, BS), got {tuple(w.shape)}")
    B, A, H, BS, _ = w.shape
    if BS > _BS_MAX:
        raise ValueError(f"the BELL kernels take block_size <= {_BS_MAX}, got {BS}")
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
    if B * H > 65535:
        raise ValueError(f"grid too large for B·H={B * H}")


def _load():
    lib = build.load("bell_bwd")
    if lib.bell_bwd_k1.argtypes is None:
        lib.bell_bwd_k1.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.bell_bwd_k1.restype = ctypes.c_int
        lib.bell_bwd_k1_wmma.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                                         + [ctypes.c_void_p])
        lib.bell_bwd_k1_wmma.restype = ctypes.c_int
        lib.bell_bwd_k1_wmma_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.bell_bwd_k1_wmma_smem_bytes.restype = ctypes.c_size_t
        lib.bell_bwd_k2.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.bell_bwd_k2.restype = ctypes.c_int
        lib.bell_bwd_k2_wmma.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 13
                                         + [ctypes.c_void_p])
        lib.bell_bwd_k2_wmma.restype = ctypes.c_int
        lib.bell_bwd_k2_wmma_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.bell_bwd_k2_wmma_smem_bytes.restype = ctypes.c_size_t
        lib.bell_bwd_error_string.argtypes = [ctypes.c_int]
        lib.bell_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.bell_bwd_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def k1_groups(T: int, TT: int) -> int:
    """dΘ partials per (batch, head, target tile): time chunks are split into
    groups of at most 4, one block each."""
    chunks = -(-T // TT)
    return -(-chunks // 4)


@debug.kernel("bell_k1")
def bell_k1_cuda(active_src, active_tgt, tile_start, tile_count, thetas, gm, x, w):
    """Launch K1 on the current stream: (dA f32, dΘ f32); bf16 operands take
    the tensor-core kernels, float32 the CUDA-core kernels."""
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
    NJ = tile_start.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        plan = k1_bf16_plan(BS, C, Co, T)
        G = plan["groups"]
    else:
        TTa, TTc = time_chunk(C, Co, T, staged=128), time_chunk(C, Co, T)
        G = k1_groups(T, TTc)
    dev = w.device
    dA = torch.empty((B, A, H, BS, BS), dtype=torch.float32, device=dev)
    # the dΘ partials (bf16: then the fixed-order row sums' groups of 64)
    S = B * NJ * G
    partial = torch.empty(((S + (-(-S // 64) if bf16 else 0)) * H, C * Co),
                          dtype=torch.float32, device=dev)
    dth = torch.empty((H, C, Co), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (active_src, active_tgt, tile_start, tile_count, thetas,
                                   gm, x, w, dA, partial, dth)]
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            aligned = lambda *ts: all(t.data_ptr() % 16 == 0 for t in ts)
            err = lib.bell_bwd_k1_wmma(
                *ptrs, B, A, H, NJ, BS, C, T, Co, plan["tn"], plan["tc"],
                int(T % _TT16 == 0 and aligned(gm, x)), int(BS % 8 == 0 and aligned(w)),
                stream)
        else:
            err = lib.bell_bwd_k1(*ptrs, B, A, H, NJ, BS, C, T, Co, TTa, TTc, G, stream)
    _raise_on(lib, err, "bell_bwd K1")
    k1_launches += 1
    return dA, dth


@debug.kernel("bell_k2")
def bell_k2_cuda(src_start, src_count, src_order, active_tgt, thetas, gm, w):
    """Launch K2 on the current stream: dx (B, NI·BS, C·T) in gm's dtype;
    bf16 operands take the tensor-core kernel, float32 the CUDA-core one."""
    global k2_launches
    _check(thetas, gm, w, (("src_start", src_start), ("src_count", src_count),
                           ("src_order", src_order), ("active_tgt", active_tgt)))
    B, A, H, BS, _ = w.shape
    _, C, Co = thetas.shape
    T = gm.shape[-1] // Co
    NI, NJ = src_start.shape[0], gm.shape[1] // BS
    dev = w.device
    dx = torch.empty((B, NI * BS, C * T), dtype=gm.dtype, device=dev)
    idx = [t.data_ptr() for t in (src_start, src_count, src_order, active_tgt, thetas)]
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if gm.dtype == torch.bfloat16:
            plan = k2_bf16_plan(BS, C, Co, T)
            split = torch.empty(H * plan["groups"][0] * 2 * _pad16(Co) * 16,
                                dtype=torch.bfloat16, device=dev)
            aligned = lambda *ts: all(t.data_ptr() % 16 == 0 for t in ts)
            err = lib.bell_bwd_k2_wmma(
                *idx, split.data_ptr(), gm.data_ptr(), w.data_ptr(), dx.data_ptr(), B, A, H,
                NI, NJ, BS, C, T, Co, plan["nt"], plan["tr"],
                int(T % _TT16 == 0 and aligned(gm, dx)), int(BS % 8 == 0 and aligned(w)),
                stream)
        else:
            err = lib.bell_bwd_k2(*idx, gm.data_ptr(), w.data_ptr(), dx.data_ptr(), B, A, H,
                                  NI, NJ, BS, C, T, Co, time_chunk(C, Co, T), stream)
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
