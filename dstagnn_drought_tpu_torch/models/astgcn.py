"""ASTGCN and, with ``attention=False``, MSTGCN — PyTorch counterpart of
``dstagnn_drought_tpu/models/astgcn.py``.

x (B, N, F, T) → (B, N, T_pred). An ASTGCN block: temporal attention
(B, T, T) re-weights the time axis → spatial attention (B, N, N) modulates a
K-order Chebyshev graph conv → width-3 temporal conv (zero-padded by one
step each side, stride ``time_strides`` in block 1 only) → 1×1 residual
conv → ReLU → LayerNorm over channels. The MSTGCN block drops both
attentions (plain Chebyshev conv). Both softmaxes run over axis 1, the
source axis. The head is JAX's (T_pred, T', 1, C_t) conv over the
(B, T', N, C_t) layout, whose one output column JAX keeps with ``[..., -1]``.

Parameters are named after the JAX pytree paths (``blocks.{i}.tat.u1``,
``blocks.{i}.thetas.{k}``, ``blocks.{i}.time_conv.weight``, ...); Θ is K
separate (C_in, C_s) parameters, each drawn with its own xavier bound as
JAX draws it. The family has no kernel: its products are einsums and
convolutions, as in JAX.
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
    tensor_from_jax,
)
from dstagnn_drought_tpu_torch.ops.cheb import cheb_conv


def temporal_attention_matrix(x: torch.Tensor, p: dict) -> torch.Tensor:
    """(B, T, T): E = Ve · σ((xᵀU1)U2 · (U3 x) + be), softmax over the
    source-time axis. x: (B, N, F, T)."""
    lhs = torch.einsum("bnft,n,fm->btm", x, p["u1"], p["u2"])  # (B, T, N)
    rhs = torch.einsum("f,bnft->bnt", p["u3"], x)              # (B, N, T)
    prod = torch.einsum("btn,bnu->btu", lhs, rhs)              # (B, T, T)
    e = torch.einsum("tu,buv->btv", p["ve"], torch.sigmoid(prod + p["be"]))
    return torch.softmax(e, dim=1)


def spatial_attention_matrix(x: torch.Tensor, p: dict) -> torch.Tensor:
    """(B, N, N): S = Vs · σ((x W1)W2 · (W3 x)ᵀ + bs), softmax over the
    source-node axis. x: (B, N, F, T)."""
    lhs = torch.einsum("bnft,t,fu->bnu", x, p["w1"], p["w2"])  # (B, N, T)
    rhs = torch.einsum("f,bmft->btm", p["w3"], x)              # (B, T, N)
    prod = torch.einsum("bnt,btm->bnm", lhs, rhs)              # (B, N, N)
    s = torch.einsum("nm,bmj->bnj", p["vs"], torch.sigmoid(prod + p["bs"]))
    return torch.softmax(s, dim=1)


def cheb_conv_with_at(x: torch.Tensor, spatial_at: torch.Tensor,
                      cheb_polys: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Chebyshev conv modulated by one shared (B, N, N) attention map:
    out_j = ReLU(Σ_k ((T_k ⊙ S)ᵀ x) Θ_k). x: (B, N, C, T) → (B, N, C_out, T)."""
    B, N, C, T = x.shape
    A = cheb_polys[None] * spatial_at[:, None]  # (B, K, N, N)
    agg = torch.einsum("bkij,bim->bkjm", A, x.reshape(B, N, C * T))
    agg = agg.reshape(B, A.shape[1], N, C, T)
    return torch.relu(torch.einsum("bkjct,kco->bjot", agg, thetas))


def _params(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class _Block(nn.Module):
    def __init__(self, spec: ModelSpec, in_channels: int, t_in: int, stride: int,
                 attention: bool):
        super().__init__()
        N, C_s, C_t = spec.num_of_vertices, spec.nb_chev_filter, spec.nb_time_filter
        self.attention = attention
        if attention:
            self.tat = nn.ParameterDict({
                "u1": _params(N), "u2": _params(in_channels, N), "u3": _params(in_channels),
                "be": _params(t_in, t_in), "ve": _params(t_in, t_in)})
            self.sat = nn.ParameterDict({
                "w1": _params(t_in), "w2": _params(in_channels, t_in),
                "w3": _params(in_channels), "bs": _params(N, N), "vs": _params(N, N)})
        self.thetas = nn.ParameterList([_params(in_channels, C_s) for _ in range(spec.K)])
        self.time_conv = nn.Conv2d(C_s, C_t, (1, 3), stride=(1, stride), padding=(0, 1))
        self.residual_conv = nn.Conv2d(in_channels, C_t, (1, 1), stride=(1, stride))
        self.ln = LayerNorm(C_t)

    def forward(self, x: torch.Tensor, cheb_polys: torch.Tensor) -> torch.Tensor:
        """x (B, N, C, T) → (B, N, C_t, T')."""
        c = lambda t: t.to(x.dtype)  # parameters in the compute dtype
        thetas = torch.stack([c(t) for t in self.thetas])
        if self.attention:
            e_norm = temporal_attention_matrix(x, {k: c(v) for k, v in self.tat.items()})
            x_tat = torch.einsum("bnct,btu->bncu", x, e_norm)
            s_norm = spatial_attention_matrix(x_tat, {k: c(v) for k, v in self.sat.items()})
            gcn = cheb_conv_with_at(x_tat, s_norm, cheb_polys, thetas)
        else:
            gcn = cheb_conv(x, cheb_polys=cheb_polys, thetas=thetas)
        time_out = conv2d(gcn.permute(0, 2, 1, 3), self.time_conv)  # (B, C_t, N, T')
        res = conv2d(x.permute(0, 2, 1, 3), self.residual_conv)
        y = torch.relu(res + time_out)
        y = self.ln(y.permute(0, 3, 2, 1))  # (B, T', N, C_t)
        return y.permute(0, 2, 3, 1)


class ASTGCN(ZooModel):
    def __init__(self, spec: ModelSpec, attention: bool = True):
        super().__init__()
        self.spec = spec
        blocks = []
        c_in, t_in = spec.in_channels, spec.len_input
        for i in range(spec.nb_block):
            stride = spec.time_strides if i == 0 else 1
            blocks.append(_Block(spec, c_in, t_in, stride, attention))
            c_in = spec.nb_time_filter
            if i == 0:
                t_in = t_in // spec.time_strides
        self.blocks = nn.ModuleList(blocks)
        t_out = spec.len_input // spec.time_strides
        self.final_conv = nn.Conv2d(t_out, spec.num_for_predict, (1, spec.nb_time_filter))

    def predict(self, x, cheb_polys, *, deterministic, generator):
        for block in self.blocks:
            x = block(x, cheb_polys)
        # final_conv over (B, T', N, C_t): its (1, C_t) kernel leaves one
        # column, so it is a contraction over (T', C_t) → (B, N, T_pred).
        # An einsum: PyTorch's CPU bf16 conv gets this shape wrong (2.13).
        w = self.final_conv.weight.to(x.dtype)[:, :, 0, :]
        return (torch.einsum("bnct,ptc->bnp", x, w)
                + self.final_conv.bias.to(x.dtype))


def make_model(spec: ModelSpec, adj_merge, adj_pa, *, seed: int = 0,
               device: torch.device | str = "cuda", attention: bool = True):
    """(model, constants): the model initialized like the reference from
    ``torch.Generator`` seed ``seed``, and the K Chebyshev polynomials of
    the merged graph with ``adj_pa``. ``device`` defaults to ``cuda`` and
    raises without a card."""
    device = resolve_device(device)
    model = init_model(ASTGCN(spec, attention), seed, device)
    return model, graph_constants(spec.K, adj_merge, adj_pa, device)


def params_from_jax(params, spec: ModelSpec) -> dict[str, torch.Tensor]:
    """A JAX ASTGCN or MSTGCN parameter pytree → this model's state_dict."""
    sd = {}
    for i, b in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        for group in ("tat", "sat"):
            for name, leaf in b.get(group, {}).items():
                sd[f"{pre}{group}.{name}"] = tensor_from_jax(leaf)
        for k in range(spec.K):
            sd[f"{pre}thetas.{k}"] = tensor_from_jax(b["thetas"][k])
        sd.update(dense_from_jax(b["time_conv"], pre + "time_conv", transpose=False))
        sd.update(dense_from_jax(b["residual_conv"], pre + "residual_conv", transpose=False))
        sd.update(layer_norm_from_jax(b["ln"], pre + "ln"))
    sd.update(dense_from_jax(params["final_conv"], "final_conv", transpose=False))
    return sd
