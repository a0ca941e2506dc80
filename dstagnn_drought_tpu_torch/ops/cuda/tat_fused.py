"""Fused temporal attention: the CUDA kernels and their plain PyTorch
version.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/tat_fused.py``. Per row of
B·F, with x (B·F, T, N):

    te   = embed ? LN(x + pos)·g0 + b0 : x
    qkv  = te · wqkv
    s_h  = q_h k_hᵀ / √d_k + res_h          (raw scores, an output)
    a_h  = softmax over the QUERY axis of s_h
    out  = LN(concat_h(a_h · v_h) · wo + te)·g1 + b1

everything in float32 whatever the input dtype, as the TPU kernel does; only
out and the scores (and, backward, dx and dres) are rounded to the caller's
dtype. The kernels (``csrc/tat_fused.cu``; its header says what bounds
them) are one design for float32 and bfloat16: passes over the flat B·F·T
rows, their products on the tensor cores with each float32 operand split
into two bf16 terms (hi + lo; in float32 x and the weights too), so the
function stays float32 in value; the N-wide passes take N in column chunks
of at most 1024, and where a head width would not fit their block, their
K operand (ctx, g_qkv) in chunks of 256 columns and g_ctx in column
groups; the attention runs a block per (row, head) on the CUDA cores, key
columns in chunks of 32 and the queries in one tile up to T = 160 where
that fits, else in tiles of 32, with d_k and d_v staged 64 columns at a
time where the whole head does not fit. So no block's shared memory grows
with N, T or the head widths, and every shape JAX's kernel takes runs
(:func:`plan` gives each pass's rows, route and shared memory;
:func:`limit_error` refuses only CUDA's grid and an int32 guard).

The backward's weight gradients are contracted over all rows by a second
pass in a fixed order, so two launches give the same bits. :class:`TatFused`
puts them together; a shape the passes refuse raises ``ValueError``. The
wrappers take the kernels for CUDA tensors and the plain version
(:func:`tat_fused_plain`, gradients from autograd) only for tensors on the
CPU; ``fwd_launches``/``bwd_launches`` count wrapper calls that launched a
direction's kernels.
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
_SMEM_TWO = 115712  # the most two blocks an SM may each have


def _ln_hat(z):
    """(z − mean)·rsqrt(var + eps) over the last axis, float32."""
    mu = z.mean(dim=-1, keepdim=True)
    var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
    return (z - mu) * torch.rsqrt(var + _EPS)


@debug.kernel("tat_fwd")
def tat_fused_plain(x, pos, g0, b0, wqkv, wo, g1, b1, res, *, n_heads, d_k, d_v, embed):
    """The kernel's function in tensor ops: x (BF, T, N), res (BF, H, T, T)
    → (out (BF, T, N), scores (BF, H, T, T)) in x's dtype."""
    BF, T, N = x.shape
    te = x.float()
    if embed:
        te = _ln_hat(te + pos.float()) * g0.float() + b0.float()
    qkv = te @ wqkv.float()
    hk = n_heads * d_k
    q = qkv[..., :hk].reshape(BF, T, n_heads, d_k)
    k = qkv[..., hk:2 * hk].reshape(BF, T, n_heads, d_k)
    v = qkv[..., 2 * hk:].reshape(BF, T, n_heads, d_v)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) * (1.0 / d_k ** 0.5) + res.float()
    attn = torch.softmax(s, dim=2)  # the query axis (reference quirk)
    ctx = torch.einsum("rhqk,rkhd->rqhd", attn, v).reshape(BF, T, n_heads * d_v)
    out = _ln_hat(ctx @ wo.float() + te) * g1.float() + b1.float()
    return out.to(x.dtype), s.to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _load():
    lib = build.load("tat_fused")
    if lib.tat_fused_forward.argtypes is None:
        lib.tat_fused_workspace_floats.argtypes = [ctypes.c_int] * 9
        lib.tat_fused_workspace_floats.restype = ctypes.c_size_t
        lib.tat_fused_smem_bytes.argtypes = [ctypes.c_int] * 8
        lib.tat_fused_smem_bytes.restype = ctypes.c_size_t
        lib.tat_fused_forward.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.tat_fused_forward.restype = ctypes.c_int
        lib.tat_fused_backward.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.tat_fused_backward.restype = ctypes.c_int
        lib.tat_fused_error_string.argtypes = [ctypes.c_int]
        lib.tat_fused_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.tat_fused_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def smem_bytes(T, N, H, d_k, d_v, backward, dtype=torch.float32, embed=False):
    """Shared memory a kernel block of a direction needs: the most any of
    the direction's passes requests (:func:`passes`) in ``dtype``."""
    plan = passes(T, N, H, d_k, d_v, embed, dtype)
    return max(plan[p][1] for p in (BWD_PASSES if backward else FWD_PASSES))


# the passes (csrc/tat_fused.cu's Pass16 order) and the directions that
# launch them
PASSES = ("qkv", "attn_fwd", "out", "ln1_bwd", "attn_bwd", "gte")
FWD_PASSES = ("qkv", "attn_fwd", "out")
BWD_PASSES = ("qkv", "attn_fwd", "ln1_bwd", "attn_bwd", "gte")
_KC, _LC, _ITEMS, _WARPS = 64, 72, 9, 8  # chunk columns, chunk row stride, tiles a warp
# attention key chunk; query tile where T is streamed, and the T up to which
# one tile holds every query; the N-wide passes' most columns a chunk
_KEYS, _QUERIES, _ONE_TILE, _MAX_CHUNK = 32, 32, 160, 1024
# the chunked attention route's head columns a stage; a split pass's ctx and
# g_qkv columns a stage, and its most g_ctx columns a group
_HEAD_CHUNK, _HV_CHUNK, _W_CHUNK, _GROUP_MAX = 64, 256, 256, 512
_INT32 = 2 ** 31


def _pad16(n):
    return (n + 15) // 16 * 16


def column_chunk(N):
    """(width, count) of the N-wide passes' column chunks (csrc/tat_fused.cu
    ``make_d16``): the padded width split evenly into the fewest chunks of at
    most 1024 columns, each a multiple of 16."""
    Np = _pad16(N)
    parts = -(-Np // _MAX_CHUNK)
    NC = _pad16(-(-Np // parts))
    return NC, -(-Np // NC)


def _attn_bytes(name, route, T, d_k, d_v):
    """Shared memory of an attention pass's block on a route (csrc
    ``attn_smem``): a query tile (every query on ``one``, else 32), key and
    value chunks of 32, score tiles, and the head's columns, whole or (on
    ``chunk``) 64 of d_k and d_v at a time with ctx's, g_k's and g_v's sums
    in device memory."""
    QT = T if route == "one" else min(T, _QUERIES)
    KC = min(T, _KEYS)
    ls, chunk = KC + 1, route == "chunk"
    lq = (min(d_k, _HEAD_CHUNK) if chunk else d_k) + 1
    lv = (min(d_v, _HEAD_CHUNK) if chunk else d_v) + 1
    if name == "attn_fwd":
        return 4 * (QT * lq + KC * lq + KC * lv + QT * ls + (0 if chunk else QT * d_v) + 2 * KC)
    return 4 * (QT * lq + QT * lv + KC * lq + KC * lv + 2 * QT * ls
                + (0 if chunk else KC * d_k + KC * d_v) + 3 * KC)


def attn_route(name, T, d_k, d_v):
    """The route an attention pass takes (csrc ``make_d16``): ``one`` (every
    query in one tile, up to T = 160), ``stream`` (query tiles of 32, the
    whole head staged) or ``chunk`` (those tiles with d_k and d_v staged 64
    columns at a time), the first whose block fits."""
    if T <= _ONE_TILE and _attn_bytes(name, "one", T, d_k, d_v) <= _SMEM_MAX:
        return "one"
    if _attn_bytes(name, "stream", T, d_k, d_v) <= _SMEM_MAX:
        return "stream"
    return "chunk"


def _ln1_group(hvp, rows, split):
    """g_ctx columns the LN1-backward pass sums at a time: all of them, or
    (split) a group whose tiles fit 9 a warp, at most 512."""
    if not split:
        return hvp
    return min(hvp, _GROUP_MAX, 16 * (_WARPS * _ITEMS // (rows // 16)))


def _pass_bytes(name, rows, T, N, H, d_k, d_v, embed, f32=False, split=False):
    """Shared memory of one pass's block at ``rows`` rows (the formulas of
    csrc/tat_fused.cu ``smem16``): the N-wide passes hold a column chunk of
    their rows (:func:`column_chunk`) and their K operand (ctx in out and
    ln1_bwd, g_qkv in gte) whole, or with ``split`` 256 columns of it at a
    time (ln1_bwd then also takes g_ctx in column groups); the attention
    passes take the route :func:`attn_route` picks, so nothing grows with N,
    T or (split, chunked) the head widths; the N-wide passes also keep their
    rows' statistics and sums. In float32 (``f32``) the qkv pass stages
    wqkv's lo chunk beside its hi chunk over half the columns and splits x,
    and the LN1-backward pass stages wo's lo chunk too."""
    R, Wp, hvp = rows, _pad16(H * (2 * d_k + d_v)), _pad16(H * d_v)
    LZ = column_chunk(N)[0] + 4
    if name == "qkv":
        gw = min(Wp, 16 * (_WARPS * _ITEMS // (R // 16)) // (1 + f32))
        return 2 * _KC * (gw + 8) * (1 + f32) + 2 * R * _LC * (1 + (embed or f32)) + 8 * R
    if name.startswith("attn"):
        return _attn_bytes(name, attn_route(name, T, d_k, d_v), T, d_k, d_v)
    hc = min(hvp, _HV_CHUNK) if split else hvp
    if name == "out":
        return 4 * R * LZ + 4 * R * (hc + 8) + 8 * R
    if name == "ln1_bwd":
        gc = _ln1_group(hvp, R, split)
        return 4 * R * LZ + max(4 * R * (hc + 8), 4 * R * _LC + 2 * gc * _LC * (1 + f32)) + 16 * R
    wc = min(Wp, _W_CHUNK) if split else Wp  # gte
    return 4 * R * (wc + 8) + (4 * R * LZ + 8 * R if embed or split else 4 * _WARPS * 256)


def _rows(name, T, N, H, d_k, d_v, embed, f32, split):
    """The most rows (64, 32, 16) of a row-tiled pass whose block lets two
    share an SM, else the most that fit, 0 where none does; unsplit, the
    LN1-backward pass also needs its g_ctx tiles, (rows/16) x ⌈H·d_v/16⌉,
    to fit 9 a warp."""
    hv16 = _pad16(H * d_v) // 16
    for cap in (_SMEM_TWO, _SMEM_MAX):
        for rows in (64, 32, 16):
            if name == "ln1_bwd" and not split and rows // 16 * hv16 > _WARPS * _ITEMS:
                continue
            if _pass_bytes(name, rows, T, N, H, d_k, d_v, embed, f32, split) <= cap:
                return rows
    return 0


def plan(T, N, H, d_k, d_v, embed=False, dtype=torch.bfloat16):
    """{pass: dict(rows, bytes, how)} of the design for inputs of ``dtype``
    (bfloat16 or float32), csrc ``make_d16``'s choices: an attention pass's
    route (``how`` = ``one``, ``stream`` or ``chunk``, :func:`attn_route`;
    rows 1, a block per (row, head)); a row-tiled pass's rows (64, 32 or 16,
    the most whose shared memory lets two blocks share an SM, else the most
    that fit) with its K operand whole (``how`` = ``whole``) where some rows
    fit, else ``split``. Every shape has a plan within a block's shared
    memory; where a shape fits the old design, the plan is that design's. A
    launch halves the rows, down to 16, while B·F·T would give fewer blocks
    than an H100's 132 SMs; 16 rows fit wherever more do."""
    f32 = dtype != torch.bfloat16
    out = {}
    for name in PASSES:
        if name.startswith("attn"):
            route = attn_route(name, T, d_k, d_v)
            out[name] = dict(rows=1, bytes=_attn_bytes(name, route, T, d_k, d_v), how=route)
            continue
        split = False
        rows = _rows(name, T, N, H, d_k, d_v, embed, f32, split)
        if rows == 0:
            split = True
            rows = _rows(name, T, N, H, d_k, d_v, embed, f32, split)
        out[name] = dict(rows=rows, how="split" if split else "whole",
                         bytes=_pass_bytes(name, rows, T, N, H, d_k, d_v, embed, f32, split))
    return out


def passes(T, N, H, d_k, d_v, embed=False, dtype=torch.bfloat16):
    """{pass: (rows, bytes)} of :func:`plan`: the most rows of B·F·T a block
    of each row-tiled pass takes and the bytes it requests there (the
    attention passes take one (row, head) a block and give rows 1)."""
    return {k: (v["rows"], v["bytes"]) for k, v in plan(T, N, H, d_k, d_v, embed, dtype).items()}


def limit_error(T, N, H, d_k, d_v, dtype, backward, embed=False, BF=1):
    """Why the forward or backward passes cannot take a shape for inputs of
    ``dtype`` on the card, or None. The passes take every N and T (column
    chunks, query tiles and key chunks) and every head width (the chunked
    attention route, the split N-wide passes), so what is left is CUDA's
    grid (H ≤ 65,535 heads on the attention grid's y, ⌈N/64⌉ and ⌈H·d_v/64⌉
    ≤ 65,535 on the weight gradients') and an int32 guard: B·F·T rows, T·N,
    N·W and H·d_v·N each below 2^31, W = H·(2·d_k + d_v). ``backward``,
    ``embed`` and ``dtype`` change the plan (:func:`plan`), never the
    answer."""
    W = H * (2 * d_k + d_v)
    if H > 65535 or -(-N // 64) > 65535 or -(-(H * d_v) // 64) > 65535:
        return (f"grid too large for the tat_fused passes: H={H}, N={N}, H·d_v={H * d_v} "
                f"(at most 65535 heads and 65535 64-column tiles)")
    for what, n in (("B·F·T", BF * T), ("T·N", T * N), ("N·W", N * W), ("H·d_v·N", H * d_v * N)):
        if n >= _INT32:
            return f"{what} = {n} is past the int32 indices of the tat_fused passes"
    return None


def _check(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v, others=(), embed=False):
    """Refuse what the passes do not take: shapes, the dtype (float32 or
    bfloat16, one for every tensor), layout, device, and a shape whose
    blocks need more shared memory than a block may have."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B·F, T, N), got {tuple(x.shape)}")
    BF, T, N = x.shape
    W = n_heads * (2 * d_k + d_v)
    shapes = {"pos": (T, N), "g0": (N,), "b0": (N,), "wqkv": (N, W),
              "wo": (n_heads * d_v, N), "g1": (N,), "b1": (N,), "res": (BF, n_heads, T, T)}
    named = dict(pos=pos, g0=g0, b0=b0, wqkv=wqkv, wo=wo, g1=g1, b1=b1, res=res)
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the tat_fused passes take float32 or bfloat16; x is {x.dtype}")
    why = limit_error(T, N, n_heads, d_k, d_v, x.dtype, backward=bool(others), embed=embed,
                      BF=BF)
    if why is not None:
        raise ValueError(why)
    tensors = (("x", x), *named.items(), *others)
    for name, t in tensors:
        if t.dtype != x.dtype:
            raise TypeError(f"the tat_fused passes take one dtype, x's {x.dtype}; {name} is "
                            f"{t.dtype}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the tat_fused kernels run on CUDA tensors; {name} is on {t.device}")


@debug.kernel("tat_fwd")
def tat_forward_cuda(x, pos, g0, b0, wqkv, wo, g1, b1, res, *, n_heads, d_k, d_v, embed,
                     out_dtype=None):
    """Launch the forward (passes 1-3) on the current stream: contiguous CUDA
    tensors, all float32 or all bfloat16 → (out (BF, T, N), scores (BF, H,
    T, T)) in ``out_dtype`` (x's dtype by default, rounded once, or
    float32)."""
    global fwd_launches
    _check(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v, embed=embed)
    out_dtype = out_dtype or x.dtype
    f32 = x.dtype == torch.float32
    BF, T, N = x.shape
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    scores = torch.empty(res.shape, dtype=out_dtype, device=x.device)
    if BF == 0:
        return out, scores
    lib = _load()
    ws = torch.empty(lib.tat_fused_workspace_floats(BF, T, N, n_heads, d_k, d_v, int(embed), 0,
                                                    int(f32)),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tat_fused_forward(
            *(t.data_ptr() for t in (x, pos, g0, b0, wqkv, wo, g1, b1, res, out, scores, ws)),
            BF, T, N, n_heads, d_k, d_v, int(embed), int(f32),
            int(out_dtype == torch.float32), stream)
    _raise_on(lib, err, "tat_fused forward")
    fwd_launches += 1
    return out, scores


@debug.kernel("tat_bwd")
def tat_backward_cuda(x, pos, g0, b0, wqkv, wo, g1, b1, res, g_out, g_sc, *, n_heads, d_k, d_v,
                      embed, out_dtype=None):
    """Launch the backward (passes 1, 2, 4-7) on the current stream: (dx,
    dres) in ``out_dtype`` (x's dtype by default, or float32), then (dpos,
    dg0, db0, dwqkv, dwo, dg1, db1) float32, the weight gradients summed
    over every row in a fixed order."""
    global bwd_launches
    _check(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v,
           others=(("g_out", g_out), ("g_sc", g_sc)), embed=embed)
    if tuple(g_out.shape) != tuple(x.shape) or tuple(g_sc.shape) != tuple(res.shape):
        raise ValueError("g_out and g_sc must have the shapes of out and scores")
    out_dtype = out_dtype or x.dtype
    f32 = x.dtype == torch.float32
    BF, T, N = x.shape
    dev = x.device
    f32t = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, dtype=out_dtype, device=dev)
    dres = torch.empty(res.shape, dtype=out_dtype, device=dev)
    if BF == 0:
        return (dx, dres, torch.zeros((T, N), **f32t), *torch.zeros((2, N), **f32t),
                torch.zeros(wqkv.shape, **f32t), torch.zeros(wo.shape, **f32t),
                *torch.zeros((2, N), **f32t))
    dpos, vec4 = torch.empty((T, N), **f32t), torch.empty((4, N), **f32t)
    dwqkv, dwo = torch.empty(wqkv.shape, **f32t), torch.empty(wo.shape, **f32t)
    lib = _load()
    ws = torch.empty(lib.tat_fused_workspace_floats(BF, T, N, n_heads, d_k, d_v, int(embed), 1,
                                                    int(f32)), **f32t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tat_fused_backward(
            *(t.data_ptr() for t in (x, pos, g0, b0, wqkv, wo, g1, b1, res, g_out, g_sc, dx,
                                     dres, dpos, vec4, dwqkv, dwo, ws)),
            BF, T, N, n_heads, d_k, d_v, int(embed), int(f32),
            int(out_dtype == torch.float32), stream)
    _raise_on(lib, err, "tat_fused backward")
    bwd_launches += 1
    dg1, db1, dg0, db0 = vec4
    return dx, dres, dpos, dg0, db0, dwqkv, dwo, dg1, db1


def _operands(*ts):
    """Contiguous operands of one dtype the passes take: bfloat16 as it is,
    any other dtype widened to float32."""
    dtype = torch.bfloat16 if ts[0].dtype == torch.bfloat16 else torch.float32
    return [t.to(dtype).contiguous() for t in ts]


class TatFused(torch.autograd.Function):
    """The forward passes, with the backward passes as their gradient: dx,
    dpos, dg0, db0, dwqkv, dwo, dg1, db1 and dres, each in its input's
    dtype. bfloat16 inputs go to the passes as they are; any other dtype is
    widened to float32."""

    @staticmethod
    def forward(ctx, x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v, embed):
        ctx.save_for_backward(x, pos, g0, b0, wqkv, wo, g1, b1, res)
        ctx.dims = dict(n_heads=n_heads, d_k=d_k, d_v=d_v, embed=embed)
        out, scores = tat_forward_cuda(*_operands(x, pos, g0, b0, wqkv, wo, g1, b1, res),
                                       **ctx.dims)
        return out.to(x.dtype), scores.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out, g_sc):
        saved = ctx.saved_tensors
        grads = tat_backward_cuda(*_operands(*saved, g_out, g_sc), **ctx.dims)
        dx, dres, dpos, dg0, db0, dwqkv, dwo, dg1, db1 = grads
        x, pos, g0, b0, wqkv, wo, g1, b1, res = saved
        cast = lambda a, like: a.to(like.dtype)
        return (cast(dx, x), cast(dpos, pos), cast(dg0, g0), cast(db0, b0),
                cast(dwqkv, wqkv), cast(dwo, wo), cast(dg1, g1), cast(db1, b1),
                cast(dres, res), None, None, None, None)


def tat_fused(x, pos, g0, b0, wqkv, wo, g1, b1, res, *, n_heads, d_k, d_v, embed):
    """The kernels for CUDA tensors, the plain version for CPU tensors
    (the counterpart of the JAX ``_tat_core``)."""
    if x.device.type == "cpu":
        return tat_fused_plain(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads=n_heads,
                               d_k=d_k, d_v=d_v, embed=embed)
    return TatFused.apply(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v, embed)


def fused_temporal_attention(
    x: torch.Tensor,
    res_att,
    *,
    pos: torch.Tensor | None,
    ln0_scale: torch.Tensor | None,
    ln0_bias: torch.Tensor | None,
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
    """Fused [EmbedT +] temporal attention [+ residual LN], with the
    arguments and layouts of the JAX ``fused_temporal_attention``: x is the
    raw block input (B, F, T, N), pre-embedding when ``pos`` is given;
    ``res_att`` is a scalar or broadcastable to (B, F, H, T, T). Returns
    (out (B, F, T, N), raw scores (B, F, H, T, T))."""
    B, F, T, N = x.shape
    embed = pos is not None
    if not embed:
        pos = torch.zeros((T, N), dtype=x.dtype, device=x.device)
        ln0_scale = torch.ones((N,), dtype=x.dtype, device=x.device)
        ln0_bias = torch.zeros((N,), dtype=x.dtype, device=x.device)
    wqkv = torch.cat([wq, wk, wv], dim=1)
    if not torch.is_tensor(res_att) or res_att.ndim == 0:
        res4 = torch.zeros((B * F, n_heads, T, T), dtype=x.dtype, device=x.device)
    else:
        res4 = res_att.broadcast_to((B, F, n_heads, T, T)).reshape(
            B * F, n_heads, T, T).to(x.dtype)
    out, scores = tat_fused(x.reshape(B * F, T, N), pos, ln0_scale, ln0_bias, wqkv, wo,
                            ln_scale, ln_bias, res4, n_heads=n_heads, d_k=d_k, d_v=d_v,
                            embed=embed)
    return out.reshape(B, F, T, N), scores.reshape(B, F, n_heads, T, T)
