"""Temporal Transformer forecaster — PyTorch counterpart of
``dstagnn_drought_tpu/models/transformer.py``.

Per node: project the F input features of each step to ``d_model``, add a
learned positional table over T, run ``nb_block`` pre-LN encoder layers
(multi-head self-attention over time, Q/K/V/O without bias, then a GELU
MLP; a dropout after each, drawn from the step's generator), a final
LayerNorm, then map the time-major flattened (T·d_model) encoding to the
horizon. Nodes are batch rows; the graph is not used. x (B, N, F, T) →
(B, N, num_for_predict).

Written as JAX writes it: attention as plain einsums with the 1/√d_k scale
in the compute dtype, and GELU's tanh approximation (``jax.nn.gelu``'s
default). ``scaled_dot_product_attention`` and ``nn.TransformerEncoderLayer``
differ from it in bias, GELU and where the softmax rounds in bf16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dstagnn_drought_tpu_torch.device import resolve_device
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec
from dstagnn_drought_tpu_torch.models.layers import (
    LayerNorm,
    ZooModel,
    dense_from_jax,
    init_model,
    layer_norm_from_jax,
    linear,
    tensor_from_jax,
)
from dstagnn_drought_tpu_torch.ops.nn import dropout

_MLP_RATIO = 4


class _Layer(nn.Module):
    def __init__(self, d: int, H: int, d_k: int):
        super().__init__()
        self.ln1 = LayerNorm(d)
        self.wq = nn.Linear(d, H * d_k, bias=False)
        self.wk = nn.Linear(d, H * d_k, bias=False)
        self.wv = nn.Linear(d, H * d_k, bias=False)
        self.wo = nn.Linear(H * d_k, d, bias=False)
        self.ln2 = LayerNorm(d)
        self.mlp_in = nn.Linear(d, _MLP_RATIO * d)
        self.mlp_out = nn.Linear(_MLP_RATIO * d, d)

    def attention(self, h: torch.Tensor, H: int, d_k: int) -> torch.Tensor:
        """Self-attention over the time axis. h: (B*, T, d)."""
        BN, T, _ = h.shape
        q, k, v = (linear(h, w).reshape(BN, T, H, d_k).transpose(1, 2)
                   for w in (self.wq, self.wk, self.wv))
        scale = torch.tensor(float(d_k), dtype=h.dtype).sqrt().item()  # √d_k rounded to h's dtype
        att = torch.softmax(torch.einsum("bhtd,bhud->bhtu", q, k) / scale, dim=-1)
        ctx = torch.einsum("bhtu,bhud->bhtd", att, v)
        return linear(ctx.transpose(1, 2).reshape(BN, T, H * d_k), self.wo)


class Transformer(ZooModel):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        d = spec.d_model
        self.in_proj = nn.Linear(spec.in_channels, d)
        self.pos = nn.Parameter(torch.empty(spec.len_input, d))
        self.layers = nn.ModuleList(
            [_Layer(d, spec.n_heads, spec.d_k) for _ in range(spec.nb_block)])
        self.ln_f = LayerNorm(d)
        self.head = nn.Linear(spec.len_input * d, spec.num_for_predict)

    def predict(self, x, cheb_polys, *, deterministic, generator):
        spec = self.spec
        B, N, F_in, T = x.shape
        h = linear(x.permute(0, 1, 3, 2).reshape(B * N, T, F_in), self.in_proj)
        h = h + self.pos.to(x.dtype)[None]
        for layer in self.layers:
            a = layer.attention(layer.ln1(h), spec.n_heads, spec.d_k)
            h = h + dropout(a, spec.dropout_rate, generator, deterministic)
            m = F.gelu(linear(layer.ln2(h), layer.mlp_in), approximate="tanh")
            m = linear(m, layer.mlp_out)
            h = h + dropout(m, spec.dropout_rate, generator, deterministic)
        h = self.ln_f(h)
        out = linear(h.reshape(B * N, T * spec.d_model), self.head)
        return out.reshape(B, N, spec.num_for_predict)


def make_model(spec: ModelSpec, adj_merge, adj_pa, *, seed: int = 0,
               device: torch.device | str = "cuda"):
    """(model, constants); the family ignores the graph, so the constants
    carry a (K, 1, 1) zero ``cheb_polys`` and ``adj_pa`` for the common
    interface."""
    device = resolve_device(device)
    model = init_model(Transformer(spec), seed, device)
    constants = {
        "cheb_polys": torch.zeros((spec.K, 1, 1), device=device),
        "adj_pa": torch.as_tensor(np.asarray(adj_pa), dtype=torch.float32).to(device),
    }
    return model, constants


def params_from_jax(params, spec: ModelSpec) -> dict[str, torch.Tensor]:
    """A JAX transformer parameter pytree → this model's state_dict."""
    sd = dense_from_jax(params["in_proj"], "in_proj", transpose=True)
    sd["pos"] = tensor_from_jax(params["pos"])
    for i, lp in enumerate(params["layers"]):
        pre = f"layers.{i}."
        for w in ("wq", "wk", "wv", "wo"):
            sd[f"{pre}{w}.weight"] = tensor_from_jax(lp[w], transpose=True)
        for ln in ("ln1", "ln2"):
            sd.update(layer_norm_from_jax(lp[ln], pre + ln))
        for mlp in ("mlp_in", "mlp_out"):
            sd.update(dense_from_jax(lp[mlp], pre + mlp, transpose=True))
    sd.update(layer_norm_from_jax(params["ln_f"], "ln_f"))
    sd.update(dense_from_jax(params["head"], "head", transpose=True))
    return sd
