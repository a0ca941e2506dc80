"""Fused GTU tail: the CUDA kernels and their plain PyTorch version.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/gtu_fused.py``. For x
(B, N, C, T) and the three GTU convs (Conv2d(C → 2C, kernel (1, k)),
k ∈ (3, 5, 7), stride 1):

    y_k  = b_k + Σ_kk Σ_c x[c, t+kk] · W_k[:, c, 0, kk]        (t < T−k+1)
    out  = concat_k tanh(y_k[:C]) ⊙ sigmoid(y_k[C:])  along time → (B, N, 3T−12, C)

x and W in the compute dtype (x's), products and the gate in float32, the
output rounded once. The kernels (``csrc/gtu_fused.cu``; its header says what
bounds them) are a forward and a backward that recomputes y, one design for
both dtypes on the tensor cores (WMMA bf16 fragments, float32 accumulators;
in float32 x, the taps and dY split into bf16 hi and lo terms): a block
owns a group of output channel pairs and a tile of time steps, contracts
over C in chunks and stages x over its tile and the taps' reach, so every
shape of :func:`supported` runs (the kernels' ``gtu_fused_plan`` gives the
tiling). The backward's dW and db are summed over every (b, n) group in a
fixed order, so two launches give the same bits. :class:`GtuCat` puts them
together. The wrappers take the kernels for CUDA tensors and the plain
version (:func:`gtu_cat_plain`, gradients from autograd, with the kernel's
rounding points) only for tensors on the CPU; ``fwd_launches`` and
``bwd_launches`` count kernel launches. The fcmy product after the concat stays a plain matmul
(:func:`gtu_fcmy`), as it stays in XLA in the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.cuda import build

KS = (3, 5, 7)
TAPS = sum(KS)

fwd_launches = 0
bwd_launches = 0


def supported(C: int, T: int, time_strides: int) -> bool:
    """Static gate of the fused path (the JAX package's): stride 1, T ≥ 48,
    16 | T and 16 | C; elsewhere the model keeps the im2col tail."""
    return time_strides == 1 and T >= 48 and T % 16 == 0 and C % 16 == 0


def out_len(T: int) -> int:
    """Length of the concatenated time axis: Σ_k (T − k + 1) = 3T − 12."""
    return sum(T - k + 1 for k in KS)


def pack(w3, b3, w5, b5, w7, b7, dtype):
    """OIHW conv weights → the kernels' operands: ``wp`` (15, 2C, C) float32,
    the taps of conv 3, then 5, then 7, each ``w[:, :, 0, kk]`` rounded to
    ``dtype`` (the compute dtype); ``bp`` (3, 2C) float32."""
    wp = torch.cat([w.to(dtype).float()[:, :, 0, :].permute(2, 0, 1)
                    for w in (w3, w5, w7)]).contiguous()
    bp = torch.stack([b.float() for b in (b3, b5, b7)]).contiguous()
    return wp, bp


def unpack_grads(dwp, dbp):
    """(dwp (15, 2C, C), dbp (3, 2C)) → per-conv OIHW (2C, C, 1, k) weight
    gradients and (2C,) bias gradients, float32."""
    dws = [seg.permute(1, 2, 0).unsqueeze(2).contiguous() for seg in dwp.split(KS)]
    return dws, list(dbp.unbind(0))


class _Gate(torch.autograd.Function):
    """tanh(p) ⊙ sigmoid(q) in float32, whose backward forms dP and dQ where
    the TPU kernel's hand-written backward does: th, sg and the cotangent in
    the compute dtype ``md``, every product rounded to it."""

    @staticmethod
    def forward(ctx, p, q, md):
        ctx.save_for_backward(p, q)
        ctx.md = md
        return torch.tanh(p) * torch.sigmoid(q)

    @staticmethod
    def backward(ctx, g):
        p, q = ctx.saved_tensors
        md = ctx.md
        th, sg, g = torch.tanh(p).to(md), torch.sigmoid(q).to(md), g.to(md)
        dp = g * sg * (1 - th * th)
        dq = g * th * sg * (1 - sg)
        return dp.float(), dq.float(), None


def _value_in(w, md):
    """w's value rounded to ``md``, as float32, with w's gradient left
    unrounded (the TPU kernel casts the weights; their gradients come back
    in float32)."""
    wf = w.float()
    return wf + (w.to(md).float() - wf).detach()


@debug.kernel("gtu_fwd")
def gtu_cat_plain(x, w3, b3, w5, b5, w7, b7):
    """The kernels' function in tensor ops: x (B, N, C, T) → (B, N, 3T−12, C)
    in x's dtype."""
    md = x.dtype
    C, T = x.shape[2], x.shape[3]
    xt = x.float().transpose(2, 3)  # (B, N, T, C)
    outs = []
    for k, w, b in zip(KS, (w3, w5, w7), (b3, b5, b7)):
        T_out = T - k + 1
        wf = _value_in(w, md)
        y = b.float()
        for kk in range(k):
            y = y + xt[:, :, kk:kk + T_out] @ wf[:, :, 0, kk].t()  # (B, N, T_out, 2C)
        outs.append(_Gate.apply(y[..., :C], y[..., C:], md))
    return torch.cat(outs, dim=2).to(md)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _load():
    lib = build.load("gtu_fused")
    if lib.gtu_fused_forward.argtypes is None:
        lib.gtu_fused_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.gtu_fused_workspace_floats.restype = ctypes.c_size_t
        lib.gtu_fused_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.gtu_fused_forward.restype = ctypes.c_int
        lib.gtu_fused_backward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.gtu_fused_backward.restype = ctypes.c_int
        lib.gtu_fused_error_string.argtypes = [ctypes.c_int]
        lib.gtu_fused_error_string.restype = ctypes.c_char_p
        lib.gtu_fused_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.gtu_fused_smem_bytes.restype = ctypes.c_size_t
        lib.gtu_fused_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gtu_fused_plan.restype = None
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.gtu_fused_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def limit_error(C, T, dtype, backward):
    """Why the kernels cannot take (C, T) on the card, or None: a shape
    outside :func:`supported` (16 | C, 16 | T, T ≥ 48); the tiles stream C
    and T, so no shared-memory cap remains."""
    if not supported(C, T, 1):
        which = "backward" if backward else "forward"
        return (f"the {which} kernel takes 16 | C, 16 | T and T ≥ 48 (C={C}, T={T}, "
                f"{dtype})")
    return None


def _check(x, wp, bp, others=()):
    if x.ndim != 4:
        raise ValueError(f"x must be (B, N, C, T), got {tuple(x.shape)}")
    B, N, C, T = x.shape
    if T < max(KS):
        raise ValueError(f"T must be at least {max(KS)}, got {T}")
    if tuple(wp.shape) != (TAPS, 2 * C, C):
        raise ValueError(f"wp must be {(TAPS, 2 * C, C)}, got {tuple(wp.shape)}")
    if tuple(bp.shape) != (len(KS), 2 * C):
        raise ValueError(f"bp must be {(len(KS), 2 * C)}, got {tuple(bp.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the gtu_fused kernels take float32 or bfloat16 x; x is {x.dtype}")
    for name, t in (("wp", wp), ("bp", bp)):
        if t.dtype != torch.float32:
            raise TypeError(f"the gtu_fused kernels take float32 {name}; it is {t.dtype}")
    for name, t in others:
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got {t.dtype}")
    for name, t in (("x", x), ("wp", wp), ("bp", bp), *others):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"the gtu_fused kernels run on CUDA tensors; {name} is on {t.device}")
    why = limit_error(C, T, x.dtype, backward=bool(others))
    if why is not None:
        raise ValueError(why)
    return B * N, C, T


@debug.kernel("gtu_fwd")
def gtu_forward_cuda(x, wp, bp):
    """Launch the forward on the current stream: x (B, N, C, T) float32 or
    bfloat16, ``pack``'s operands → (B, N, 3T−12, C) in x's dtype."""
    global fwd_launches
    BN, C, T = _check(x, wp, bp)
    # the kernels load x 16 bytes at a time
    x = x.clone() if x.data_ptr() % 16 else x
    out = torch.empty((*x.shape[:2], out_len(T), C), dtype=x.dtype, device=x.device)
    if BN == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gtu_fused_forward(x.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
                                    BN, C, T, int(x.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "gtu_fused forward")
    fwd_launches += 1
    return out


@debug.kernel("gtu_bwd")
def gtu_backward_cuda(x, g, wp, bp):
    """Launch the backward on the current stream: the cotangent g
    (B, N, 3T−12, C) → (dx in x's dtype, dwp (15, 2C, C), dbp (3, 2C)
    float32), dwp and dbp summed over every (b, n) group in a fixed order."""
    global bwd_launches
    BN, C, T = _check(x, wp, bp, others=(("g", g),))
    if tuple(g.shape) != (*x.shape[:2], out_len(T), C):
        raise ValueError(f"g must be {(*x.shape[:2], out_len(T), C)}, got {tuple(g.shape)}")
    # the kernels load x and g 16 bytes at a time
    x, g = (t.clone() if t.data_ptr() % 16 else t for t in (x, g))
    dx = torch.empty_like(x)
    dwb = torch.zeros(TAPS * 2 * C * C + len(KS) * 2 * C, dtype=torch.float32, device=x.device)
    if BN > 0:
        lib = _load()
        ws = torch.empty(lib.gtu_fused_workspace_floats(BN, C, T, int(x.dtype == torch.bfloat16)),
                         dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.gtu_fused_backward(x.data_ptr(), g.data_ptr(), wp.data_ptr(),
                                         bp.data_ptr(), dx.data_ptr(), dwb.data_ptr(),
                                         ws.data_ptr(), BN, C, T,
                                         int(x.dtype == torch.bfloat16), stream)
        _raise_on(lib, err, "gtu_fused backward")
        bwd_launches += 1
    n = TAPS * 2 * C * C
    return dx, dwb[:n].view(TAPS, 2 * C, C), dwb[n:].view(len(KS), 2 * C)


class GtuCat(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient: dx in
    x's dtype, each weight and bias gradient in its parameter's dtype."""

    @staticmethod
    def forward(ctx, x, w3, b3, w5, b5, w7, b7):
        x = x.contiguous()
        ctx.save_for_backward(x, w3, b3, w5, b5, w7, b7)
        return gtu_forward_cuda(x, *pack(w3, b3, w5, b5, w7, b7, x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        wp, bp = pack(*params, x.dtype)
        dx, dwp, dbp = gtu_backward_cuda(x, g.to(x.dtype).contiguous(), wp, bp)
        dws, dbs = unpack_grads(dwp, dbp)
        w3, b3, w5, b5, w7, b7 = params
        return (dx, dws[0].to(w3.dtype), dbs[0].to(b3.dtype), dws[1].to(w5.dtype),
                dbs[1].to(b5.dtype), dws[2].to(w7.dtype), dbs[2].to(b7.dtype))


def gtu_cat(x, w3, b3, w5, b5, w7, b7):
    """The kernels for CUDA tensors, the plain version for CPU tensors (the
    counterpart of the JAX ``gtu_cat``): x (B, N, C, T) → (B, N, 3T−12, C)."""
    if x.device.type == "cpu":
        return gtu_cat_plain(x, w3, b3, w5, b5, w7, b7)
    return GtuCat.apply(x, w3, b3, w5, b5, w7, b7)


def gtu_fcmy(x, w3, b3, w5, b5, w7, b7, wfc, bfc):
    """The fused GTU tail with the arguments and layouts of the JAX
    ``gtu_fcmy``: x (B, N, C, T), wfc (3T−12, T), bfc (T,) → (B, N, C, T).
    The fcmy contraction is a plain matmul after the kernel."""
    gc = gtu_cat(x, w3, b3, w5, b5, w7, b7)
    return (torch.einsum("bnmc,mt->bnct", gc, wfc.to(gc.dtype))
            + bfc.to(gc.dtype)[None, None, None, :])
