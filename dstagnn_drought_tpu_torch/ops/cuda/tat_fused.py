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
dtype. The kernels (``csrc/tat_fused.cu``; its header says what bounds them)
are a forward and a backward that recomputes the forward; the backward's
weight gradients are contracted over all rows by a second pass in a fixed
order, so two launches give the same bits. :class:`TatFused` puts them
together. The wrappers take the kernels for CUDA tensors and the plain
version (:func:`tat_fused_plain`, gradients from autograd) only for tensors
on the CPU; ``fwd_launches``/``bwd_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch.ops.cuda import build

fwd_launches = 0
bwd_launches = 0

_EPS = 1e-5
_SMEM_MAX = 227 * 1024


def _ln_hat(z):
    """(z − mean)·rsqrt(var + eps) over the last axis, float32."""
    mu = z.mean(dim=-1, keepdim=True)
    var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
    return (z - mu) * torch.rsqrt(var + _EPS)


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
        lib.tat_fused_workspace_floats.argtypes = [ctypes.c_int] * 6
        lib.tat_fused_workspace_floats.restype = ctypes.c_size_t
        lib.tat_fused_forward.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.tat_fused_forward.restype = ctypes.c_int
        lib.tat_fused_backward.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.tat_fused_backward.restype = ctypes.c_int
        lib.tat_fused_error_string.argtypes = [ctypes.c_int]
        lib.tat_fused_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.tat_fused_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def smem_bytes(T, N, H, d_k, d_v, backward):
    """Shared memory a kernel block needs: the row's activations (float32;
    the formulas of csrc/tat_fused.cu)."""
    W = H * (2 * d_k + d_v)
    if backward:
        n = 5 * T * N + 2 * T * W + 2 * H * T * T + 2 * T * H * d_v + 2 * T
    else:
        n = 2 * T * N + T * W + H * T * T + T * H * d_v + T
    return 4 * n


def _check(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v, others=()):
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
    for name, t in (("x", x), *named.items(), *others):
        if t.dtype != torch.float32:
            raise TypeError(f"the tat_fused kernels take float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the tat_fused kernels run on CUDA tensors; {name} is on {t.device}")
    need = smem_bytes(T, N, n_heads, d_k, d_v, backward=bool(others))
    if need > _SMEM_MAX:
        raise ValueError(f"a row needs {need} bytes of shared memory, more than the "
                         f"{_SMEM_MAX} a block may have (T={T}, N={N})")


def tat_forward_cuda(x, pos, g0, b0, wqkv, wo, g1, b1, res, *, n_heads, d_k, d_v, embed):
    """Launch the forward on the current stream: float32 contiguous CUDA
    tensors → (out (BF, T, N), scores (BF, H, T, T)) float32."""
    global fwd_launches
    _check(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v)
    BF, T, N = x.shape
    out = torch.empty_like(x)
    scores = torch.empty_like(res)
    if BF == 0:
        return out, scores
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tat_fused_forward(
            x.data_ptr(), pos.data_ptr(), g0.data_ptr(), b0.data_ptr(), wqkv.data_ptr(),
            wo.data_ptr(), g1.data_ptr(), b1.data_ptr(), res.data_ptr(), out.data_ptr(),
            scores.data_ptr(), BF, T, N, n_heads, d_k, d_v, int(embed), stream)
    _raise_on(lib, err, "tat_fused forward")
    fwd_launches += 1
    return out, scores


def tat_backward_cuda(x, pos, g0, b0, wqkv, wo, g1, b1, res, g_out, g_sc, *,
                      n_heads, d_k, d_v, embed):
    """Launch the backward on the current stream: (dx, dres, dpos, dg0, db0,
    dwqkv, dwo, dg1, db1), all float32; the weight gradients are summed over
    every row in a fixed order."""
    global bwd_launches
    _check(x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v,
           others=(("g_out", g_out), ("g_sc", g_sc)))
    if tuple(g_out.shape) != tuple(x.shape) or tuple(g_sc.shape) != tuple(res.shape):
        raise ValueError("g_out and g_sc must have the shapes of out and scores")
    BF, T, N = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    dres = torch.empty_like(res)
    dpos = torch.zeros((T, N), dtype=torch.float32, device=dev)
    vec4 = torch.empty((4, N), dtype=torch.float32, device=dev)
    dwqkv = torch.empty_like(wqkv)
    dwo = torch.empty_like(wo)
    # transposed weights, so the backward's products read them coalesced
    wqkv_t, wo_t = wqkv.t().contiguous(), wo.t().contiguous()
    lib = _load()
    ws = torch.empty(lib.tat_fused_workspace_floats(BF, T, N, n_heads, d_k, d_v),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tat_fused_backward(
            x.data_ptr(), pos.data_ptr(), g0.data_ptr(), b0.data_ptr(), wqkv.data_ptr(),
            wqkv_t.data_ptr(), wo.data_ptr(), wo_t.data_ptr(), g1.data_ptr(),
            res.data_ptr(), g_out.data_ptr(), g_sc.data_ptr(), dx.data_ptr(),
            dres.data_ptr(), dpos.data_ptr(), vec4.data_ptr(), dwqkv.data_ptr(),
            dwo.data_ptr(), ws.data_ptr(), BF, T, N, n_heads, d_k, d_v, int(embed), stream)
    _raise_on(lib, err, "tat_fused backward")
    bwd_launches += 1
    dg1, db1, dg0, db0 = vec4
    return dx, dres, dpos, dg0, db0, dwqkv, dwo, dg1, db1


def _f32(*ts):
    return [t.float().contiguous() for t in ts]


class TatFused(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient: dx,
    dpos, dg0, db0, dwqkv, dwo, dg1, db1 and dres, each in its input's
    dtype."""

    @staticmethod
    def forward(ctx, x, pos, g0, b0, wqkv, wo, g1, b1, res, n_heads, d_k, d_v, embed):
        ctx.save_for_backward(x, pos, g0, b0, wqkv, wo, g1, b1, res)
        ctx.dims = dict(n_heads=n_heads, d_k=d_k, d_v=d_v, embed=embed)
        out, scores = tat_forward_cuda(*_f32(x, pos, g0, b0, wqkv, wo, g1, b1, res),
                                       **ctx.dims)
        return out.to(x.dtype), scores.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out, g_sc):
        saved = ctx.saved_tensors
        grads = tat_backward_cuda(*_f32(*saved, g_out, g_sc), **ctx.dims)
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
