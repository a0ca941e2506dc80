"""Fused attention-modulated Chebyshev aggregation: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``dstagnn_drought_tpu/ops/pallas/cheb_sat.py``. For every
(batch b, order k)

    A[b,k] = T_k ⊙ softmax_i(S[b,k] + adj_pa ⊙ mask_k)      (column softmax)
    agg[b,k,j,:] = Σ_i A[b,k,i,j] · X[b,i,:]                    (Aᵀ @ X)

The kernel (``csrc/cheb_sat.cu``; its header says what bounds it and how the
design answers) keeps the (B,K,N,N) operator out of device memory. The
wrapper takes the kernel for CUDA tensors and the plain version
(:func:`sat_aggregate_plain`) only for tensors on the CPU; it never falls
back from one to the other. ``launches`` counts kernel launches.

Backward (:class:`SatAggregate`): the JAX package's ``_sat_bwd`` in tensor
ops — recompute the softmax, dx = A·g, dA = x·gᵀ, then the source-axis
softmax backward gives dscores and dbias; the Chebyshev stack gets no
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from dstagnn_drought_tpu_torch.ops.cuda import build

launches = 0


def sat_aggregate_plain(scores, bias, cheb, x):
    """agg[b,k,j,m] = Σ_i (T_k ⊙ softmax_i(scores+bias))[i,j] · x[b,i,m]."""
    p = torch.softmax(scores + bias[None], dim=2)
    return torch.einsum("bkij,bim->bkjm", cheb[None] * p, x)


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
        if t.dtype != torch.float32:
            raise TypeError(f"the cheb_sat kernel takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B * K > 65535 or -(-N // 64) > 65535:
        raise ValueError(f"grid too large for B·K={B * K}, N={N}")


def _load():
    lib = build.load("cheb_sat")
    fn = lib.cheb_sat_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.cheb_sat_error_string.argtypes = [ctypes.c_int]
        lib.cheb_sat_error_string.restype = ctypes.c_char_p
    return lib


def sat_aggregate_cuda(scores, bias, cheb, x):
    """Launch the kernel on the current stream. Float32 contiguous CUDA
    tensors; returns (B, K, N, M) float32."""
    global launches
    _check(scores, bias, cheb, x)
    if scores.device.type != "cuda":
        raise ValueError(f"the cheb_sat kernel runs on CUDA tensors, got {scores.device}")
    B, K, N, _ = scores.shape
    M = x.shape[-1]
    out = torch.empty((B, K, N, M), dtype=torch.float32, device=scores.device)
    if out.numel() == 0:
        return out
    colmax = torch.empty((B, K, N), dtype=torch.float32, device=scores.device)
    colinv = torch.empty_like(colmax)
    lib = _load()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.cheb_sat_forward(
            scores.data_ptr(), bias.data_ptr(), cheb.data_ptr(), x.data_ptr(),
            out.data_ptr(), colmax.data_ptr(), colinv.data_ptr(),
            B, K, N, M, stream,
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
            dx = torch.einsum("bkij,bkjm->bim", cheb[None] * p, g)
        if need_s or need_b:
            # dA[b,k,i,j] = Σ_m x[b,i,m] g[b,k,j,m]; softmax backward over i
            dp = cheb[None] * torch.einsum("bim,bkjm->bkij", x, g)
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
    in float32; the Θ mix and the ReLU run outside the kernel; the result is
    cast back to ``x.dtype``."""
    B, N, C, T = x.shape
    bias = adj_pa[None, :, :] * masks  # (K, N, N); dmasks comes from autograd
    agg = SatAggregate.apply(
        spatial_attention.float().contiguous(),
        bias.float().contiguous(),
        cheb_polys.float().contiguous(),
        x.reshape(B, N, C * T).float().contiguous(),
    )
    agg = agg.reshape(B, thetas.shape[0], N, C, T)
    out = torch.einsum("bkjct,kco->bjot", agg, thetas.float())
    return torch.relu(out).to(x.dtype)
