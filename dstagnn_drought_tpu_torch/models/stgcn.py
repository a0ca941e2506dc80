"""STGCN — PyTorch counterpart of ``dstagnn_drought_tpu/models/stgcn.py``.

x (B, N, F, T) → (B, N, T_pred). Each ST-Conv block: gated temporal conv
(GLU, width KT = 3) → Chebyshev graph conv (ReLU) → gated temporal conv →
LayerNorm over channels. Each block eats 2·(KT − 1) time steps and blocks
stop when the time axis would run out, so at T = 12 only two of
``nb_block = 4`` exist. The head is a per-node linear map from the
remaining channels-major (C·T) features to the horizon.

Parameters are named after the JAX pytree paths: a GLU's ``w``/``b`` are
``glu{1,2}.conv.weight``/``.bias``, its ``res_w`` ``glu{1,2}.res.weight``;
Θ is K separate (C_t, C_s) parameters.
"""
from __future__ import annotations

import torch
from torch import nn

from dstagnn_drought_tpu_torch.device import resolve_device
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec
from dstagnn_drought_tpu_torch.models.layers import (
    LayerNorm,
    ZooModel,
    conv2d,
    dense_from_jax,
    graph_constants,
    init_model,
    layer_norm_from_jax,
    linear,
    tensor_from_jax,
)
from dstagnn_drought_tpu_torch.ops.cheb import cheb_conv

KT = 3  # temporal kernel width


class _GLU(nn.Module):
    """Gated linear unit temporal conv with aligned residual:
    (P + x_aligned) ⊙ σ(Q). x: (B, C_in, N, T) → (B, c_out, N, T-KT+1)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, 2 * c_out, (1, KT))
        self.res = nn.Conv2d(c_in, c_out, (1, 1), bias=False)  # channel alignment

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.conv)
        x_res = conv2d(x, self.res)[..., KT - 1:]  # the last T-KT+1 steps
        c_out = self.res.out_channels
        return (y[:, :c_out] + x_res) * torch.sigmoid(y[:, c_out:])


class _Block(nn.Module):
    def __init__(self, spec: ModelSpec, c_in: int):
        super().__init__()
        C_t, C_s = spec.nb_time_filter, spec.nb_chev_filter
        self.glu1 = _GLU(c_in, C_t)
        self.thetas = nn.ParameterList(
            [nn.Parameter(torch.empty(C_t, C_s)) for _ in range(spec.K)])
        self.glu2 = _GLU(C_s, C_t)
        self.ln = LayerNorm(C_t)


class STGCN(ZooModel):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        blocks = []
        c_in, t = spec.in_channels, spec.len_input
        for _ in range(spec.nb_block):
            if t - 2 * (KT - 1) <= 0:
                break  # each block consumes 2·(KT−1) time steps
            blocks.append(_Block(spec, c_in))
            c_in = spec.nb_time_filter
            t -= 2 * (KT - 1)
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(spec.nb_time_filter * t, spec.num_for_predict)

    def predict(self, x, cheb_polys, *, deterministic, generator):
        h = x.permute(0, 2, 1, 3)  # (B, C, N, T)
        for b in self.blocks:
            h = b.glu1(h)
            thetas = torch.stack([t.to(x.dtype) for t in b.thetas])
            g = cheb_conv(h.permute(0, 2, 1, 3), cheb_polys=cheb_polys, thetas=thetas)
            h = b.glu2(g.permute(0, 2, 1, 3))
            h = b.ln(h.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)
        B, C, N, T = h.shape
        return linear(h.permute(0, 2, 1, 3).reshape(B, N, C * T), self.head)


def make_model(spec: ModelSpec, adj_merge, adj_pa, *, seed: int = 0,
               device: torch.device | str = "cuda"):
    """(model, constants) as :func:`..astgcn.make_model` builds them."""
    device = resolve_device(device)
    model = init_model(STGCN(spec), seed, device)
    return model, graph_constants(spec.K, adj_merge, adj_pa, device)


def params_from_jax(params, spec: ModelSpec) -> dict[str, torch.Tensor]:
    """A JAX STGCN parameter pytree → this model's state_dict."""
    sd = {}
    for i, b in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        for glu in ("glu1", "glu2"):
            sd.update(dense_from_jax(b[glu], f"{pre}{glu}.conv", transpose=False))
            sd[f"{pre}{glu}.res.weight"] = tensor_from_jax(b[glu]["res_w"])
        for k in range(spec.K):
            sd[f"{pre}thetas.{k}"] = tensor_from_jax(b["thetas"][k])
        sd.update(layer_norm_from_jax(b["ln"], pre + "ln"))
    sd.update(dense_from_jax(params["head"], "head", transpose=True))
    return sd
