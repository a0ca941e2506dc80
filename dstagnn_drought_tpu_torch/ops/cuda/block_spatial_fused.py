"""Fused spatial middle of a dense DSTAGNN block: the CUDA kernels and their
plain PyTorch version.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/block_spatial_fused.py``.
Per batch row b, with md the matmul dtype (the dtype of ``tat``):

    x_tat = tat · pw + pb
    semx  = md((LN(x_tat + pos)·gs + bs) ⊙ dmask / keep)
    qk    = semx · wqk
    att_k = softmax over the SOURCE axis of md(q_k)·md(k_k)ᵀ/√d_k + bias_k
    out   = relu(Σ_k md(md(T_k ⊙ att_k)ᵀ · xm) · Θ_k)        (Θ per time step)

Matmul operands are rounded to md where the TPU kernel casts them, sums
stay float32. The TPU kernel's Kronecker factor kron(Θ_k, I_T) is a device
of its matrix unit; here Θ mixes per time step and dΘ (K, C, Co) comes back
directly. The kernels (``csrc/block_spatial_fused.cu``; its header says what
bounds them and how the work is split) stream the source and target axes in
tiles, as flash attention streams its keys, and take C, Co, d and the
SAt's d_k in chunks where a block cannot hold them whole, so no block's
shared memory grows with N, F·T, C·T or those widths (:func:`plan`,
:func:`smem_bytes`; :func:`limit_error` refuses only CUDA's grid and an
int32 guard); they never write the
(B, K, N, N) planes in the forward. The backward's weight gradients are
summed over the batch in a fixed order, so two launches give the same bits.
The backward reads the ReLU mask the forward kernel produced (``y > 0``,
kept by :class:`SpatialMiddle`), as ``torch.relu``'s backward reads its
output. The N²·C·T products run on the tensor cores in both dtypes, on a
copy of xm laid out by time chunk (:func:`_xm_chunks`): one bf16 product in
bfloat16, three in float32 (each operand split into bf16 hi + lo, float32
in value). :class:`SpatialMiddle` puts them together. The wrappers take the
kernels for CUDA tensors and the plain version (:func:`spatial_middle_plain`,
gradients from autograd) only for tensors on the CPU;
``fwd_launches``/``bwd_launches`` count launches.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.cuda import build

fwd_launches = 0
bwd_launches = 0

_EPS = 1e-5
_SMEM_MAX = 227 * 1024
_TILE = 16  # rows or target columns a kernel block takes


class _Round(torch.autograd.Function):
    """``a`` rounded to ``md`` (as float32) in the forward when ``value``,
    and its cotangent rounded to ``md`` when ``grad``: the casts of the TPU
    kernel's forward and of its hand-written backward, which do not always
    sit at the same place."""

    @staticmethod
    def forward(ctx, a, md, value, grad):
        ctx.md, ctx.grad = md, grad
        return a.to(md).float() if value else a

    @staticmethod
    def backward(ctx, g):
        return (g.to(ctx.md).float() if ctx.grad else g), None, None, None


@debug.kernel("spatial_fwd")
def spatial_middle_plain(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, *,
                         K, d_k, keep):
    """The kernels' function in tensor ops: tat (B, N, F·T), xm (B, N, C·T),
    dmask (B or 1, N, d) of 0/1, thetas (K, C, Co) → (B, N, Co·T) in tat's
    dtype. The casts to the matmul dtype sit where the TPU kernel puts them,
    in the forward and (through :class:`_Round`) in the backward."""
    md = tat.dtype
    r = lambda a: a.to(md).float()  # the cast to the matmul dtype, both ways
    value_only = lambda a: _Round.apply(a, md, True, False)
    grad_only = lambda a: _Round.apply(a, md, False, True)
    B, N, _ = tat.shape
    _, C, Co = thetas.shape
    T = xm.shape[-1] // C
    z = grad_only(r(tat) @ r(pw)) + pb.float() + pos.float()
    mu = z.mean(dim=-1, keepdim=True)
    var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
    xs_hat = (z - mu) * torch.rsqrt(var + _EPS)
    semx = value_only((xs_hat * gs.float() + bs.float()) * dmask.float() * (1.0 / keep))
    qk = semx @ r(wqk)
    hk = K * d_k
    xmm = r(xm)
    out = None
    for k in range(K):
        q = r(qk[..., k * d_k:(k + 1) * d_k])
        kk = r(qk[..., hk + k * d_k:hk + (k + 1) * d_k])
        s = grad_only(q @ kk.transpose(1, 2) * (1.0 / d_k ** 0.5)) + bias[k].float()
        att = torch.softmax(s, dim=1)  # the source axis i, per target column j
        A = value_only(cheb[k].float() * att)
        agg = r(A.transpose(1, 2) @ xmm).reshape(B, N, C, T)
        o = torch.einsum("bjct,co->bjot", agg, r(thetas[k])).reshape(B, N, Co * T)
        out = o if out is None else out + o
    return torch.relu(out).to(md)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

# the kernels of csrc/block_spatial_fused.cu, in the order of its
# spatial_fused_smem_bytes: the embedding pass (both directions), the column
# statistics (both directions), the forward's column pass, the backward's
# column pass, its ds column pass, dq and dxm row passes, and SD
KERNELS = ("embed", "stats", "cols_fwd", "cols_bwd", "ds", "dq", "rows_bwd", "embed_bwd")
_SRC, _TGT = 64, 64    # sources a column pass, targets a row pass stream a step
_CHUNK_COLS = 8 * 3 * 16  # the most columns of a chunk (8 warps x 3 tiles of 16)
_FC = 128              # tat columns a float32 embedding block takes a step
# d_k columns the score passes stage a time where d_k is chunked; d columns
# a split SA or SD block holds at a time, 2·K·d_k columns a split SD stages
_DKC, _DC, _HC = 128, 1024, 512
_INT32 = 2 ** 31


def _pad16(n):
    return (n + 15) // 16 * 16


def channel_chunks(C):
    """(Cc, nCc): C channels in the fewest chunks of at most 384 (C itself
    up to 384), balanced (csrc ``channel_chunks``; Co likewise)."""
    n = max(1, -(-C // _CHUNK_COLS))
    return -(-C // n), n


def time_chunks(T, C, Co):
    """(Tc, nTc): the time chunk of the column and row passes, Tc steps a
    chunk whose Cc·Tc and Coc·Tc columns fit 384 (at least one step; Cc,
    Coc the channel chunks), balanced over nTc chunks. Θ mixes per time
    step, so the chunks are exact."""
    w = max(channel_chunks(C)[0], channel_chunks(Co)[0], 1)
    most = min(T, max(1, _CHUNK_COLS // w))
    n = -(-T // most)
    return -(-T // n), n


def chunk_layout(N, C, T, Co):
    """(Tc, nCh, Cc·Tc padded to 16, N padded to 64): the chunked copies of
    xm and dagg, (B, nCh, Npad, CTcp) a k, nCh = nTc·nCc chunks, chunk h
    the time chunk h // nCc and the channel chunk h % nCc (csrc
    spatial_fused_chunks). Up to C = 384 nCh = nTc."""
    Tc, nT = time_chunks(T, C, Co)
    Cc, nC = channel_chunks(C)
    return Tc, nT * nC, _pad16(Cc * Tc), -(-N // _SRC) * _SRC


def _embed_rows(FT, d):
    """Rows a bf16 embedding block takes (flat over (b, i)): 32, or 16 where
    32 rows do not fit a block's shared memory."""
    return 32 if _embed_wmma_bytes(32, FT, d) <= _SMEM_MAX else 16


def _embed_wmma_bytes(rows, FT, d):
    return 4 * (rows * (_pad16(d) + 4) + 8 * 256) + 2 * rows * (64 + 8)


def _bytes(N, FT, C, T, Co, d, K, dkc, d_k, bf16, sa_split, sd_split):
    """Every kernel's bytes at a plan (csrc's *_smem formulas)."""
    t, hk2 = 16, 2 * K * d_k
    Tc, _, CTcp, _ = chunk_layout(N, C, T, Co)
    CoTc = channel_chunks(Co)[0] * Tc
    nCoc = channel_chunks(Co)[1]
    lq = (dkc + 3) // 4 * 4  # a staged query row; a key row has 4 floats more
    lk = lq + 4
    a_tiles = 2 * 2 * _SRC * t  # A's hi and lo bf16 tiles
    DC, HC = min(d, _DC), min(hk2, _HC)
    out = {"stats": 4 * (t * lk + _SRC * lq + 8 * t * 2),
           "cols_fwd": 4 * (t * lk + _SRC * lq + 32 + t * CTcp + t * CoTc) + a_tiles,
           "ds": 4 * (t * lk + _SRC * lq + (0 if dkc < d_k else t * d_k) + 3 * t + 9 * _SRC * t),
           "dq": 4 * ((_TGT + t) * dkc + t * _TGT),
           "rows_bwd": 4 * (t * lq + _TGT * lk + 2 * _TGT + t * CTcp) + a_tiles}
    out["cols_bwd"] = out["cols_fwd"] + 4 * t * CTcp * (bf16 + (nCoc > 1))
    if sa_split:
        out["embed"] = 4 * (t * (_FC + DC) + 2 * t)
    elif bf16:
        out["embed"] = _embed_wmma_bytes(_embed_rows(FT, d), FT, d)
    else:
        out["embed"] = 4 * t * (_FC + d)
    out["embed_bwd"] = 4 * (t * (HC + DC) + 2 * t) if sd_split else 4 * t * (hk2 + d)
    return out


def plan(N, FT, C, T, Co, d, K, d_k, dtype=torch.float32):
    """The kernels' plan for the compute dtype (csrc ``make_dims``): dkc, the
    d_k columns the score passes stage at a time (d_k where every one of
    them fits with all of it, else 128); ``sa_split`` and ``sd_split``, the
    embedding passes taking d in chunks of 1024 (SD also 2·K·d_k in chunks
    of 512) where a block cannot hold their whole rows; and ``bytes``, each
    kernel's shared memory (keyed as ``KERNELS``)."""
    bf16 = dtype == torch.bfloat16
    scores = ("stats", "cols_fwd", "cols_bwd", "ds", "dq", "rows_bwd")
    for dkc in (d_k, min(d_k, _DKC)):
        need = _bytes(N, FT, C, T, Co, d, K, dkc, d_k, bf16, False, False)
        if all(need[k] <= _SMEM_MAX for k in scores):
            break
    sa_split = need["embed"] > _SMEM_MAX
    sd_split = need["embed_bwd"] > _SMEM_MAX
    need = _bytes(N, FT, C, T, Co, d, K, dkc, d_k, bf16, sa_split, sd_split)
    return dict(dkc=dkc, sa_split=sa_split, sd_split=sd_split,
                bytes={k: need[k] for k in KERNELS})


def smem_bytes(N, FT, C, T, Co, d, K, d_k, dtype=torch.float32):
    """Shared memory a block of each kernel requests, for the compute dtype
    (the formulas of csrc/block_spatial_fused.cu at :func:`plan`'s choices,
    keyed as ``KERNELS``). None grows with N, F·T or C·T, nor past their
    chunks with C, Co, d or d_k: the tiles (16 rows or columns, 64 sources
    or targets a step), the staged d_k columns, d (1024 where SA or SD is
    split) and a chunk's Cc·Tc and Coc·Tc columns (at most 384) set them.
    The embedding pass holds a (16, 128) chunk of tat and x_tat (16, d) in
    float32; in bfloat16 x_tat (its rows hold semx after the LayerNorm), a
    64-column chunk of md(tat) and 8 warps' 16x16 staging (32 rows a block,
    or 16); split, (16, 1024) of x_tat in both dtypes. The backward's column
    pass also holds the aggregation of A's lo terms (16, Cc·Tc) beside agg
    in bf16, and dagg's sums (16, Cc·Tc) where Co is chunked."""
    return plan(N, FT, C, T, Co, d, K, d_k, dtype)["bytes"]


def limit_error(N, FT, C, T, Co, d, K, d_k, dtype, B=1):
    """Why the kernels cannot take the spatial middle's shape in ``dtype``
    on the card, or None. Every width fits a block (C and Co in chunks of at
    most 384 columns, d_k in chunks of 128, d in chunks of 1024: :func:`plan`),
    so what is left is CUDA's grid (the batch, K and the column and row
    passes' chunks at most 65,535) and an int32 guard: B·N times each row
    width (F·T, C·T, Co·T, d, 2·K·d_k) and K·C·Co below 2^31. ``dtype``
    changes the plan, never the answer."""
    Tc, nT = time_chunks(T, C, Co)
    nC, nCo = channel_chunks(C)[1], channel_chunks(Co)[1]
    if max(B, K, nT * nC, nT * nCo) > 65535:
        return (f"grid too large for B={B}, K={K}, T={T}, C={C}, Co={Co} (the batch, K and "
                f"{nT * max(nC, nCo)} chunks at most 65535)")
    width = max(FT, C * T, Co * T, d, 2 * K * d_k)
    for what, n in (("B·N·(widest row)", B * N * width), ("K·C·Co", K * C * Co)):
        if n >= _INT32:
            return f"{what} = {n} is past the int32 indices of the block_spatial_fused kernels"
    return None


def _load():
    lib = build.load("block_spatial_fused")
    if lib.spatial_fused_forward.argtypes is None:
        lib.spatial_fused_workspace_floats.argtypes = [ctypes.c_int] * 11
        lib.spatial_fused_workspace_floats.restype = ctypes.c_size_t
        lib.spatial_fused_smem_bytes.argtypes = [ctypes.c_int] * 10
        lib.spatial_fused_smem_bytes.restype = ctypes.c_size_t
        lib.spatial_fused_chunks.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]  # 6 ints out
        lib.spatial_fused_chunks.restype = None
        tail = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.spatial_fused_forward.argtypes = [ctypes.c_void_p] * 17 + tail
        lib.spatial_fused_forward.restype = ctypes.c_int
        lib.spatial_fused_backward.argtypes = [ctypes.c_void_p] * 28 + tail
        lib.spatial_fused_backward.restype = ctypes.c_int
        lib.spatial_fused_error_string.argtypes = [ctypes.c_int]
        lib.spatial_fused_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.spatial_fused_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _check(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, K, d_k, bf16,
           others=(), relu_mask=None):
    if tat.ndim != 3 or xm.ndim != 3 or xm.shape[:2] != tat.shape[:2]:
        raise ValueError(f"tat must be (B, N, F·T) and xm (B, N, C·T), got "
                         f"{tuple(tat.shape)}, {tuple(xm.shape)}")
    B, N, FT = tat.shape
    if thetas.ndim != 3 or thetas.shape[0] != K or xm.shape[2] % thetas.shape[1]:
        raise ValueError(f"thetas must be (K={K}, C, Co) with C | C·T, got {tuple(thetas.shape)}")
    C, Co = thetas.shape[1:]
    T = xm.shape[2] // C
    d = pos.shape[-1]
    shapes = {"pw": (FT, d), "pb": (d,), "pos": (N, d), "gs": (d,), "bs": (d,),
              "wqk": (d, 2 * K * d_k), "bias": (K, N, N), "cheb": (K, N, N)}
    named = dict(pw=pw, pb=pb, pos=pos, gs=gs, bs=bs, wqk=wqk, bias=bias, cheb=cheb)
    if dmask is not None:
        shapes["dmask"] = (B, N, d)
        named["dmask"] = dmask
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    tensors = (("tat", tat), ("xm", xm), ("thetas", thetas), *named.items(), *others)
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the block_spatial_fused kernels take float32; {name} is {t.dtype}")
    if relu_mask is not None:
        if tuple(relu_mask.shape) != (B, N, Co * T):
            raise ValueError(f"relu_mask must be {(B, N, Co * T)}, got {tuple(relu_mask.shape)}")
        if relu_mask.dtype != torch.bool:
            raise TypeError(f"relu_mask must be torch.bool (the forward's y > 0), got "
                            f"{relu_mask.dtype}")
        tensors += (("relu_mask", relu_mask),)
    why = limit_error(N, FT, C, T, Co, d, K, d_k, torch.bfloat16 if bf16 else torch.float32, B)
    if why is not None:
        raise ValueError(why)
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != tat.device:
            raise ValueError(f"the block_spatial_fused kernels run on CUDA tensors; "
                             f"{name} is on {t.device}")
    return B, N, FT, C, T, Co, d


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _bf16_operands(pw, wqk, bf16):
    """The bf16 embedding pass's copies of pw (F·T, d) and wqk (d, 2·K·d_k),
    each zero-padded to multiples of 16 (the operands are bf16-exact
    already: nothing is lost); Nones in float32."""
    if not bf16:
        return None, None
    out = []
    for a in (pw, wqk):
        p = torch.zeros((_pad16(a.shape[0]), _pad16(a.shape[1])), dtype=torch.bfloat16,
                        device=a.device)
        p[:a.shape[0], :a.shape[1]] = a
        out.append(p)
    return tuple(out)


def _xm_chunks(xm, C, T, Co, bf16):
    """xm (B, N, C·T) laid out by chunk for the tensor-core products: (B,
    nCh, Npad, CTcp) bf16 with element [b, h·nCc + g, i, c·Tc + t] = xm[b,
    i, (g·Cc + c)·T + h·Tc + t] (time chunk h, channel chunk g), zero past
    N, past the last step or channel and past Cc·Tc (:func:`chunk_layout`).
    bfloat16: xm is bf16-exact, one copy (lo None); float32: hi = bf16(xm)
    and lo = bf16(xm − hi), csrc's wm::split."""
    B, N, _ = xm.shape
    Tc, nCh, CTcp, Npad = chunk_layout(N, C, T, Co)
    Cc, nC = channel_chunks(C)
    n = nCh // nC
    x = xm.float().reshape(B, N, C, T)
    x = torch.nn.functional.pad(x, (0, n * Tc - T, 0, nC * Cc - C))
    x = x.reshape(B, N, nC, Cc, n, Tc).permute(0, 4, 2, 1, 3, 5).reshape(B, nCh, N, Cc * Tc)
    full = torch.zeros((B, nCh, Npad, CTcp), dtype=torch.float32, device=xm.device)
    full[:, :, :N, :Cc * Tc] = x
    hi = full.bfloat16()
    return hi, None if bf16 else (full - hi.float()).bfloat16()


@debug.kernel("spatial_fwd")
def spatial_forward_cuda(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, *,
                         K, d_k, keep, bf16):
    """Launch the forward on the current stream: float32 contiguous CUDA
    tensors (``dmask`` None for no dropout) → (B, N, Co·T) float32. With
    ``bf16`` the operands are bf16-exact and each tensor-core product is one
    bf16 product, else three (hi/lo split); the embedding pass runs on the
    tensor cores in bf16."""
    global fwd_launches
    B, N, FT, C, T, Co, d = _check(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb,
                                   thetas, K, d_k, bf16)
    y = torch.empty((B, N, Co * T), dtype=torch.float32, device=tat.device)
    lib = _load()
    ws = torch.empty(lib.spatial_fused_workspace_floats(B, N, FT, C, T, Co, d, K, d_k, 0,
                                                        int(bf16)),
                     dtype=torch.float32, device=tat.device)
    chunks = _xm_chunks(xm, C, T, Co, bf16)
    padded = _bf16_operands(pw, wqk, bf16)
    with torch.cuda.device(tat.device):
        stream = torch.cuda.current_stream(tat.device).cuda_stream
        err = lib.spatial_fused_forward(
            tat.data_ptr(), _ptr(dmask), pw.data_ptr(), pb.data_ptr(), pos.data_ptr(),
            gs.data_ptr(), bs.data_ptr(), wqk.data_ptr(), bias.data_ptr(), cheb.data_ptr(),
            thetas.data_ptr(), *map(_ptr, chunks), *map(_ptr, padded), y.data_ptr(),
            ws.data_ptr(), B, N, FT, C, T, Co, d, K, d_k, float(keep), int(bf16), stream)
    _raise_on(lib, err, "block_spatial_fused forward")
    fwd_launches += 1
    return y


@debug.kernel("spatial_bwd")
def spatial_backward_cuda(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas,
                          g_out, relu_mask, *, K, d_k, keep, bf16):
    """Launch the backward on the current stream: (dtat, dxm, dpw, dpb, dpos,
    dgs, dbs, dwqk, dbias, dthetas), all float32; the weight gradients are
    summed over the batch in a fixed order. ``relu_mask`` (B, N, Co·T)
    torch.bool is where the forward kernel's float32 output was > 0.
    ``bf16`` as the forward's."""
    global bwd_launches
    B, N, FT, C, T, Co, d = _check(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb,
                                   thetas, K, d_k, bf16, others=(("g_out", g_out),),
                                   relu_mask=relu_mask)
    if tuple(g_out.shape) != (B, N, Co * T):
        raise ValueError(f"g_out must be {(B, N, Co * T)}, got {tuple(g_out.shape)}")
    dev = tat.device
    f32 = dict(dtype=torch.float32, device=dev)
    dtat, dxm = torch.empty_like(tat), torch.empty_like(xm)
    dpw, dvec = torch.empty_like(pw), torch.empty((3, d), **f32)
    dpos, dwqk = torch.empty_like(pos), torch.empty_like(wqk)
    dbias, dth = torch.empty_like(bias), torch.empty_like(thetas)
    # transposed weights, so the backward's products read them coalesced
    pw_t, wqk_t = pw.t().contiguous(), wqk.t().contiguous()
    lib = _load()
    ws = torch.empty(lib.spatial_fused_workspace_floats(B, N, FT, C, T, Co, d, K, d_k, 1,
                                                        int(bf16)), **f32)
    chunks = _xm_chunks(xm, C, T, Co, bf16)
    padded = _bf16_operands(pw, wqk, bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spatial_fused_backward(
            tat.data_ptr(), _ptr(dmask), pw.data_ptr(), pw_t.data_ptr(), pb.data_ptr(),
            pos.data_ptr(), gs.data_ptr(), bs.data_ptr(), wqk.data_ptr(), wqk_t.data_ptr(),
            bias.data_ptr(), cheb.data_ptr(), thetas.data_ptr(), g_out.data_ptr(),
            relu_mask.data_ptr(), *map(_ptr, chunks), *map(_ptr, padded), dtat.data_ptr(),
            dxm.data_ptr(), dpw.data_ptr(), dvec.data_ptr(), dpos.data_ptr(), dwqk.data_ptr(),
            dbias.data_ptr(), dth.data_ptr(), ws.data_ptr(), B, N, FT, C, T, Co, d, K, d_k,
            float(keep), int(bf16), stream)
    _raise_on(lib, err, "block_spatial_fused backward")
    bwd_launches += 1
    dpb, dgs, dbs = dvec
    return dtat, dxm, dpw, dpb, dpos, dgs, dbs, dwqk, dbias, dth


def _kernel_operands(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas):
    """float32 contiguous operands; the weights rounded to the matmul dtype
    first, as the TPU kernel casts them (a no-op for weights already in it)."""
    md = tat.dtype
    f = lambda a: a.float().contiguous()
    r = lambda a: a.to(md).float().contiguous()
    return (f(tat), f(xm), None if dmask is None else f(dmask), r(pw), f(pb), f(pos),
            f(gs), f(bs), r(wqk), f(bias), f(cheb), r(thetas))


class SpatialMiddle(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient (no
    gradient for the dropout mask or the Chebyshev planes). The forward
    keeps where its float32 output is > 0 (one byte an element; not the
    bf16 output, in which a positive float32 below 2^-133 rounds to 0), and
    the backward masks the cotangent with it."""

    @staticmethod
    def forward(ctx, tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, K, d_k,
                keep):
        ctx.dims = dict(K=K, d_k=d_k, keep=keep, bf16=tat.dtype == torch.bfloat16)
        ops = _kernel_operands(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas)
        y = spatial_forward_cuda(*ops, **ctx.dims)
        ctx.save_for_backward(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas,
                              y > 0)
        return y.to(tat.dtype)

    @staticmethod
    def backward(ctx, g):
        *saved, relu_mask = ctx.saved_tensors
        ops = _kernel_operands(*saved)
        grads = spatial_backward_cuda(*ops, g.float().contiguous(), relu_mask, **ctx.dims)
        dtat, dxm, dpw, dpb, dpos, dgs, dbs, dwqk, dbias, dth = grads
        tat, xm, _, pw, pb, pos, gs, bs, wqk, bias, _, thetas = saved
        cast = lambda a, like: a.to(like.dtype)
        return (cast(dtat, tat), cast(dxm, xm), None, cast(dpw, pw), cast(dpb, pb),
                cast(dpos, pos), cast(dgs, gs), cast(dbs, bs), cast(dwqk, wqk),
                cast(dbias, bias), None, cast(dth, thetas), None, None, None)


def spatial_middle(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, *,
                   K, d_k, keep):
    """The kernels for CUDA tensors, the plain version for CPU tensors (the
    counterpart of the JAX ``_core``, with Θ (K, C, Co) for its Kronecker
    factor). ``dmask`` None means no dropout."""
    if tat.device.type == "cpu":
        if dmask is None:
            dmask = torch.ones((1,) + tuple(pos.shape), dtype=tat.dtype)
        return spatial_middle_plain(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb,
                                    thetas, K=K, d_k=d_k, keep=keep)
    args = (tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return SpatialMiddle.apply(*args, K, d_k, keep)
    # no gradient is recorded (evaluation): the forward kernel alone, no ReLU mask kept
    y = spatial_forward_cuda(*_kernel_operands(*args), K=K, d_k=d_k, keep=keep,
                             bf16=tat.dtype == torch.bfloat16)
    return y.to(tat.dtype)


def fused_spatial_middle(
    tat_out: torch.Tensor,
    x: torch.Tensor,
    *,
    pre_w: torch.Tensor,
    pre_b: torch.Tensor,
    pos: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    adj_pa: torch.Tensor,
    masks: torch.Tensor,
    cheb_polys: torch.Tensor,
    thetas: torch.Tensor,
    K: int,
    d_k: int,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Fused spatial middle of a DSTAGNN block, with the arguments of the
    JAX ``fused_spatial_middle``: tat_out (B, F, T, N), x (B, N, C, T),
    pre_w (d, T, 1, F) → (B, N, Co, T) in tat_out's dtype. The dropout mask
    is drawn from ``generator`` as ``ops.nn.dropout`` draws it (one
    ``torch.rand((B, N, d))``), so the fused and unfused paths take the same
    bits from one generator."""
    B, F, T, N = tat_out.shape
    C = x.shape[2]
    d = pos.shape[-1]
    # pre_conv weight → (F·T, d) in the (f, t) order of tat_flat
    pw = pre_w[:, :, 0, :].permute(2, 1, 0).reshape(F * T, d)
    tat_flat = tat_out.reshape(B, F * T, N).transpose(1, 2)  # (B, N, F·T)
    xm = x.reshape(B, N, C * T)
    wqk = torch.cat([wq, wk], dim=1)
    bias = adj_pa[None] * masks  # (K, N, N); dmasks comes from autograd
    dmask, keep = None, 1.0
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        dmask = (torch.rand((B, N, d), generator=generator, device=tat_out.device)
                 < keep).to(tat_out.dtype)
    out = spatial_middle(tat_flat.contiguous(), xm, dmask, pw, pre_b, pos, ln_scale,
                         ln_bias, wqk, bias, cheb_polys, thetas, K=K, d_k=d_k, keep=keep)
    return out.reshape(B, N, thetas.shape[-1], T)
