"""Fused attention-modulated Chebyshev aggregation: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/cheb_sat.py``. For every
(batch b, order k)

    A[b,k] = T_k ⊙ softmax_i(S[b,k] + adj_pa ⊙ mask_k)      (column softmax)
    agg[b,k,j,:] = Σ_i A[b,k,i,j] · X[b,i,:]                    (Aᵀ @ X)

The kernel (``csrc/cheb_sat.cu``; its header says what bounds it and how the
design answers) runs Aᵀ·X on the tensor cores, float32 in value: A and a
float32 X split into bf16 hi + lo, three bf16 products (two where X is
bf16). :func:`sat_plan` picks its tiles, stages and passes from the shape.
The wrapper takes the kernel for CUDA tensors and the plain version
(:func:`sat_aggregate_plain`) only for tensors on the CPU; it never falls
back from one to the other. ``launches`` counts wrapper calls that launch
the kernel's passes.

Backward (:class:`SatAggregate`): the JAX package's ``_sat_bwd`` in tensor
ops — recompute the softmax, dx = A·g, dA = x·gᵀ, then the source-axis
softmax backward gives dscores and dbias; the Chebyshev stack gets no
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.ops.cuda import build

launches = 0

_TJS = (128, 64)               # target columns a product block
_TMS = (256, 128, 64, 32, 16)  # feature columns a product block
_KC = 32                       # source rows a stage
# dynamic shared memory a block may take: two blocks an SM (8 warps), or
# one (16 warps, at 256 features)
_SMEM_LIMIT = {8: 115712, 16: 232448}


def _warps(tm):
    """Warps a product block: 16 at 256 features (one block an SM), else 8."""
    return 16 if tm > 128 else 8


def _pad(n, m):
    return -(-n // m) * m


def _tile(n, sizes):
    """The largest size whose padding of n is at most an eighth of the
    padded extent, else the one that pads least (the larger on a tie)."""
    for t in sizes:
        if 8 * (_pad(n, t) - n) <= _pad(n, t):
            return t
    return min(sizes, key=lambda t: (_pad(n, t), -t))


def sat_smem_bytes(tj, tm, xs, stages):
    """Dynamic shared memory a product block requests (the formula of
    csrc/cheb_sat.cu ``sat_smem``): ``stages`` stages of A's hi and lo
    (32 × (tj + 8) bf16 each) and x's hi, and lo where ``xs`` (32 × (tm + 8)),
    at least the epilogue's staging (a 16 × 20 float tile a warp)."""
    stage = 2 * _KC * (2 * (tj + 8) + (1 + xs) * (tm + 8))
    return max(stages * stage, 4 * _warps(tm) * 16 * 20)


def _scratch_bytes(B, K, N, M, x_is_bf16):
    """Bytes of scratch (the layout of csrc/cheb_sat.cu ``scratch_layout``,
    each part 256-byte aligned): colmax and colinv, A's hi and lo planes
    (B·K, N, pad8(N)), x's planes (B, N, pad8(M)) where x is float32 (hi
    and lo) or bf16 with M % 8 != 0 (hi)."""
    stats = _pad(4 * B * K * N, 256)
    a = _pad(4 * B * K * N * _pad(N, 8), 256)
    x = 0
    if not x_is_bf16 or M % 8:
        x = _pad(2 * (1 if x_is_bf16 else 2) * B * N * _pad(M, 8), 256)
    return 2 * stats + a + x


def sat_plan(B, K, N, M, x_is_bf16):
    """The kernel's launch plan at (B, K, N, M) with x in bf16 or float32:
    {"tj", "tm": the product block's targets × features (the largest of
    128, 64 (and 256 and 32, 16 for tm) padding at most an eighth, else the
    one that pads least), "warps": 8, or 16 at tm = 256, "stages": cp.async
    stages of 32 source rows (the most of 4, 3, 2 that fit: two blocks an
    SM at 8 warps, one at 16), "x_planes": whether x is rewritten as bf16
    planes first (float32 x, or M % 8 != 0), "products": bf16 products a
    product (3, or 2 where x is bf16: its lo is zero), "smem": the product
    block's dynamic shared bytes, "scratch": bytes (A's planes the most of
    it), "grid": (M tiles, target tiles, B·K)}."""
    tj, tm = _tile(N, _TJS), _tile(M, _TMS)
    xs = 0 if x_is_bf16 else 1
    stages = next(s for s in (4, 3, 2)
                  if sat_smem_bytes(tj, tm, xs, s) <= _SMEM_LIMIT[_warps(tm)])
    return {"tj": tj, "tm": tm, "warps": _warps(tm), "stages": stages,
            "x_planes": bool(xs or M % 8), "products": 3 if xs else 2,
            "smem": sat_smem_bytes(tj, tm, xs, stages),
            "scratch": _scratch_bytes(B, K, N, M, x_is_bf16),
            "grid": (-(-M // tm), -(-N // tj), B * K)}


@debug.kernel("cheb_sat")
def sat_aggregate_plain(scores, bias, cheb, x):
    """agg[b,k,j,m] = Σ_i (T_k ⊙ softmax_i(scores+bias))[i,j] · x[b,i,m], in
    the scores' dtype (a bf16 x is widened, as the kernel reads it)."""
    p = torch.softmax(scores + bias[None], dim=2)
    return torch.einsum("bkij,bim->bkjm", cheb[None] * p, x.to(p.dtype))


def _check(scores, bias, cheb, x):
    if scores.ndim != 4 or scores.shape[2] != scores.shape[3]:
        raise ValueError(f"scores must be (B, K, N, N), got {tuple(scores.shape)}")
    B, K, N, _ = scores.shape
    if x.ndim != 3 or tuple(x.shape[:2]) != (B, N):
        raise ValueError(f"x must be (B={B}, N={N}, M), got {tuple(x.shape)}")
    for name, t in (("bias", bias), ("cheb", cheb)):
        if tuple(t.shape) != (K, N, N):
            raise ValueError(f"{name} must be (K={K}, N={N}, N), got {tuple(t.shape)}")
    for name, t in (("scores", scores), ("bias", bias), ("cheb", cheb), ("x", x)):
        if t.device != scores.device:
            raise ValueError(f"{name} is on {t.device}, scores on {scores.device}")
        if t.dtype != torch.float32 and not (name == "x" and t.dtype == torch.bfloat16):
            raise TypeError(f"the cheb_sat kernel takes float32 (x also bfloat16); "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B * K > 65535 or -(-N // 64) > 65535:
        raise ValueError(f"grid too large for B·K={B * K}, N={N}")


def _load():
    lib = build.load("cheb_sat")
    fn = lib.cheb_sat_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.cheb_sat_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.cheb_sat_smem_bytes.restype = ctypes.c_size_t
        lib.cheb_sat_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.cheb_sat_scratch_bytes.restype = ctypes.c_size_t
        lib.cheb_sat_error_string.argtypes = [ctypes.c_int]
        lib.cheb_sat_error_string.restype = ctypes.c_char_p
    return lib


@debug.kernel("cheb_sat")
def sat_aggregate_cuda(scores, bias, cheb, x):
    """Launch the plan's passes on the current stream. Float32 contiguous
    CUDA tensors, x float32 or bf16; returns (B, K, N, M) float32."""
    global launches
    _check(scores, bias, cheb, x)
    if scores.device.type != "cuda":
        raise ValueError(f"the cheb_sat kernel runs on CUDA tensors, got {scores.device}")
    B, K, N, _ = scores.shape
    M = x.shape[-1]
    out = torch.empty((B, K, N, M), dtype=torch.float32, device=scores.device)
    if out.numel() == 0:
        return out
    x_bf16 = x.dtype == torch.bfloat16
    plan = sat_plan(B, K, N, M, x_bf16)
    if not plan["x_planes"] and x.data_ptr() % 16:
        x = x.clone()  # the product stages x's rows by 16-byte copies
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=scores.device)
    lib = _load()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.cheb_sat_forward(
            scores.data_ptr(), bias.data_ptr(), cheb.data_ptr(), x.data_ptr(), int(x_bf16),
            out.data_ptr(), scratch.data_ptr(), B, K, N, M, plan["tj"], plan["tm"],
            plan["stages"], stream,
        )
    if err != 0:
        msg = lib.cheb_sat_error_string(err).decode()
        raise RuntimeError(f"cheb_sat kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def fused_sat_aggregate(scores, bias, cheb, x):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if scores.device.type == "cpu":
        return sat_aggregate_plain(scores, bias, cheb, x)
    return sat_aggregate_cuda(scores, bias, cheb, x)


class SatAggregate(torch.autograd.Function):
    """Differentiable :func:`fused_sat_aggregate` (no gradient for ``cheb``)."""

    @staticmethod
    def forward(ctx, scores, bias, cheb, x):
        ctx.save_for_backward(scores, bias, cheb, x)
        return fused_sat_aggregate(scores, bias, cheb, x)

    @staticmethod
    def backward(ctx, g):
        scores, bias, cheb, x = ctx.saved_tensors
        need_s, need_b, _, need_x = ctx.needs_input_grad
        # recompute the softmax (cheap vs. saving (B,K,N,N) activations)
        p = torch.softmax(scores + bias[None], dim=2)
        dscores = dbias = dx = None
        if need_x:
            # dX[b,i,m] = Σ_{k,j} A[b,k,i,j] g[b,k,j,m]
            dx = torch.einsum("bkij,bkjm->bim", cheb[None] * p, g).to(x.dtype)
        if need_s or need_b:
            # dA[b,k,i,j] = Σ_m x[b,i,m] g[b,k,j,m]; softmax backward over i
            dp = cheb[None] * torch.einsum("bim,bkjm->bkij", x.to(p.dtype), g)
            dsb = p * (dp - (p * dp).sum(dim=2, keepdim=True))
            dscores = dsb if need_s else None
            dbias = dsb.sum(dim=0) if need_b else None
        return dscores, dbias, None, dx


def cheb_conv_with_sat_pallas(
    x: torch.Tensor,
    spatial_attention: torch.Tensor,
    adj_pa: torch.Tensor,
    *,
    cheb_polys: torch.Tensor,
    masks: torch.Tensor,
    thetas: torch.Tensor,
) -> torch.Tensor:
    """Drop-in for ``ops.cheb.cheb_conv_with_sat`` through the kernel (the
    name follows the JAX package's ``use_pallas`` knob). The aggregation runs
    in float32 (a bf16 x goes in as it is: its float32 value is exact, and
    the kernel then drops the product with x's zero lo plane); the Θ mix and
    the ReLU run outside the kernel; the result is cast back to
    ``x.dtype``."""
    B, N, C, T = x.shape
    bias = adj_pa[None, :, :] * masks  # (K, N, N); dmasks comes from autograd
    xm = x.reshape(B, N, C * T)
    agg = SatAggregate.apply(
        spatial_attention.float().contiguous(),
        bias.float().contiguous(),
        cheb_polys.float().contiguous(),
        (xm if xm.dtype == torch.bfloat16 else xm.float()).contiguous(),
    )
    agg = agg.reshape(B, thetas.shape[0], N, C, T)
    out = torch.einsum("bkjct,kco->bjot", agg, thetas.float())
    return torch.relu(out).to(x.dtype)
