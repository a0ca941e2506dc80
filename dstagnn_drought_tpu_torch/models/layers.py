"""Parameter initializers mirroring the reference's init scheme.

Counterpart of ``dstagnn_drought_tpu/models/layers.py``. The reference
re-initializes *every* parameter after construction: ndim > 1 →
xavier_uniform, ndim <= 1 → U(0, 1), including biases and LayerNorm affine
parameters. The draws come from an explicit ``torch.Generator``; exact
weight parity with the JAX package goes through ``params_from_jax``. Below
the initializers, the layer pieces and factory helpers of the zoo families.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dstagnn_drought_tpu_torch.ops.graph import cheb_polynomials, scaled_laplacian
from dstagnn_drought_tpu_torch.ops.nn import layer_norm


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``nn.init.xavier_uniform_`` (gain=1): for conv weights (O, I, kh, kw),
    fan_in = I·kh·kw, fan_out = O·kh·kw."""
    if t.ndim < 2:
        raise ValueError("xavier_uniform needs ndim >= 2")
    receptive = 1
    for s in t.shape[2:]:
        receptive *= s
    bound = (6.0 / (t.shape[1] * receptive + t.shape[0] * receptive)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def ref_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``nn.init.uniform_`` default U(0, 1)."""
    with torch.no_grad():
        return t.uniform_(0.0, 1.0, generator=generator)


def init_like_reference_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every parameter of ``module`` like the reference's loop."""
    for p in module.parameters():
        if p.ndim > 1:
            xavier_uniform_(p, generator)
        else:
            ref_uniform_(p, generator)


# ---------------------------------------------------------------------------
# layer pieces of the zoo families (JAX ``linear_params``, ``conv2d_params``,
# ``layer_norm_params``): float32 parameters, applied in the input's dtype
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """LayerNorm over the last axis with the JAX package's parameter names
    (``scale``, ``bias``), both drawn U(0, 1) like every ndim-1 parameter."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale.to(x.dtype), self.bias.to(x.dtype))


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ Wᵀ + b`` with the weights cast to x's dtype."""
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (NCHW / OIHW, its stride and zero padding) with the weights
    cast to x's dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, stride=conv.stride,
                    padding=conv.padding)


class ZooModel(nn.Module):
    """Base of the zoo families. The forward takes the keyword set of the
    DSTAGNN forward, which ``training/step.py`` passes; ``adj_pa``,
    ``use_pallas``, ``bell``, ``bell_tiles``, ``ell`` and ``fuse_*`` are
    accepted and ignored, as the JAX families ignore them. x and
    ``cheb_polys`` are cast to ``compute_dtype`` (the weights in
    :meth:`predict`, float32 masters kept); the output is float32. With
    ``return_attention`` it is ``(out, [])``: the zoo families export no
    spatial map, as in JAX."""

    def forward(self, x, *, adj_pa=None, cheb_polys, deterministic: bool = True,
                generator: torch.Generator | None = None,
                compute_dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                bell=None, bell_tiles=None, ell=None, fuse_tat: bool = False,
                fuse_spatial: bool = False, fuse_gtu: bool = False,
                return_attention: bool = False):
        out = self.predict(x.to(compute_dtype), cheb_polys.to(compute_dtype),
                           deterministic=deterministic, generator=generator).float()
        return (out, []) if return_attention else out

    def predict(self, x, cheb_polys, *, deterministic, generator):
        """x (B, N, F, T) in the compute dtype → (B, N, num_for_predict)."""
        raise NotImplementedError


def init_model(model: nn.Module, seed: int, device: torch.device) -> nn.Module:
    """``model`` initialized like the reference from ``torch.Generator`` seed
    ``seed`` (drawn on the CPU, so the weights do not depend on the device),
    on ``device``."""
    init_like_reference_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def graph_constants(K: int, adj_merge, adj_pa, device: torch.device) -> dict:
    """``cheb_polys`` (K Chebyshev polynomials of the merged graph's scaled
    Laplacian) and ``adj_pa``, on ``device``."""
    L_tilde = scaled_laplacian(torch.as_tensor(np.asarray(adj_merge), dtype=torch.float32))
    return {"cheb_polys": cheb_polynomials(L_tilde, K).to(device),
            "adj_pa": torch.as_tensor(np.asarray(adj_pa), dtype=torch.float32).to(device)}


def tensor_from_jax(a, transpose: bool = False) -> torch.Tensor:
    """A JAX (numpy-convertible) leaf as a float32 CPU tensor."""
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(np.array(a.T if transpose else a, order="C"))


def dense_from_jax(p: dict, prefix: str, *, transpose: bool) -> dict:
    """A JAX ``{"w", "b"}`` dict as ``<prefix>.weight``/``.bias`` entries;
    ``transpose`` for a linear kernel, which JAX stores (d_in, d_out)."""
    sd = {f"{prefix}.weight": tensor_from_jax(p["w"], transpose)}
    if "b" in p:
        sd[f"{prefix}.bias"] = tensor_from_jax(p["b"])
    return sd


def layer_norm_from_jax(p: dict, prefix: str) -> dict:
    """A JAX ``{"scale", "bias"}`` dict as ``<prefix>.scale``/``.bias`` entries."""
    return {f"{prefix}.scale": tensor_from_jax(p["scale"]),
            f"{prefix}.bias": tensor_from_jax(p["bias"])}
