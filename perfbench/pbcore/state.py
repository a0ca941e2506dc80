"""The seeded initial weights, and the BELL tile layout of the masks.

Both sides get one state: the benchmark draws it on the card from the seed,
in the reference implementation's ``state_dict`` layout, with the
reference's initialisation (xavier-uniform for every tensor of two or more
axes, U(0, 1) for the rest), in one call to the generator. On the BELL tiles
path the program keeps the learnable masks only on the graph's active tiles
(``mask_tiles``, (A, K, BS, BS)); :class:`Tiles` works that support out of
the graph again and moves masks between the two layouts.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def param_shapes(spec: dict) -> dict:
    """{state_dict name: shape} of the DSTAGNN of ``spec`` (dense masks)."""
    N, T, P = spec["num_of_vertices"], spec["len_input"], spec["num_for_predict"]
    H, dk, dv, K, d = spec["n_heads"], spec["d_k"], spec["d_v"], spec["K"], spec["d_model"]
    C, Co = spec["nb_time_filter"], spec["nb_chev_filter"]
    first = (spec["in_channels"], spec["in_channels"])
    out = {}
    for i, (F, C_in) in enumerate([first] + [(C, Co)] * (spec["nb_block"] - 1)):
        b = f"BlockList.{i}."
        out.update({
            b + "EmbedT.pos_embed.weight": (T, N), b + "EmbedT.norm.weight": (N,),
            b + "EmbedT.norm.bias": (N,),
            b + "TAt.W_Q.weight": (H * dk, N), b + "TAt.W_K.weight": (H * dk, N),
            b + "TAt.W_V.weight": (H * dv, N), b + "TAt.fc.weight": (N, H * dv),
            b + "TAt.layer_norm.weight": (N,), b + "TAt.layer_norm.bias": (N,),
            b + "pre_conv.weight": (d, T, 1, F), b + "pre_conv.bias": (d,),
            b + "EmbedS.pos_embed.weight": (N, d), b + "EmbedS.norm.weight": (d,),
            b + "EmbedS.norm.bias": (d,),
            b + "SAt.W_Q.weight": (K * dk, d), b + "SAt.W_K.weight": (K * dk, d),
        })
        for k in range(K):
            out[b + f"cheb_conv_SAt.Theta.{k}"] = (C_in, Co)
        for k in range(K):
            out[b + f"cheb_conv_SAt.mask.{k}"] = (N, N)
        for w in (3, 5, 7):
            out[b + f"gtu{w}.con2out.weight"] = (2 * C, C, 1, w)
            out[b + f"gtu{w}.con2out.bias"] = (2 * C,)
        out.update({b + "fcmy.0.weight": (T, 3 * T - 12), b + "fcmy.0.bias": (T,),
                    b + "residual_conv.weight": (C, C_in, 1, 1),
                    b + "residual_conv.bias": (C,), b + "ln.weight": (C,),
                    b + "ln.bias": (C,)})
    out.update({"final_conv.weight": (128, T * spec["nb_block"], 1, C),
                "final_conv.bias": (128,), "final_fc.weight": (P, 128),
                "final_fc.bias": (P,)})
    return out


def initial_state(spec: dict, seed: int, device) -> dict:
    """The seeded initial weights, drawn on ``device`` in one call."""
    shapes = param_shapes(spec)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = u[at:at + n].view(shape)
        at += n
        if len(shape) > 1:
            field = math.prod(shape[2:])
            bound = math.sqrt(6.0 / (shape[0] * field + shape[1] * field))
            v = (2.0 * v - 1.0) * bound
        out[name] = v.clone()
    return out


class Tiles:
    """The BELL tile support of a graph: target tiles in order, and in each
    the source blocks that hold an edge into it (self loops included),
    ascending. ``to_tiles`` cuts (N, N) masks to (A, BS, BS) tiles of the
    active list; ``to_dense`` puts tiles back, zero elsewhere."""

    def __init__(self, adj, block_size: int):
        a = np.asarray(adj) != 0
        n = a.shape[0]
        a = a | np.eye(n, dtype=bool)
        nb = -(-n // block_size)
        pad = np.zeros((nb * block_size, nb * block_size), bool)
        pad[:n, :n] = a
        hit = pad.reshape(nb, block_size, nb, block_size).any(axis=(1, 3))  # (src, tgt)
        pairs = [(s, t) for t in range(nb) for s in range(nb) if hit[s, t]]
        self.n, self.bs, self.nb = n, block_size, nb
        self.src = torch.tensor([s for s, _ in pairs])
        self.tgt = torch.tensor([t for _, t in pairs])

    @property
    def active(self) -> int:
        return len(self.src)

    def _grid(self, dense):
        n_pad = self.nb * self.bs
        d = torch.nn.functional.pad(dense, (0, n_pad - self.n, 0, n_pad - self.n))
        return d.reshape(self.nb, self.bs, self.nb, self.bs).permute(0, 2, 1, 3)

    def to_tiles(self, dense: torch.Tensor) -> torch.Tensor:
        g = self._grid(dense)
        return g[self.src.to(g.device), self.tgt.to(g.device)]

    def to_dense(self, tiles: torch.Tensor) -> torch.Tensor:
        g = torch.zeros(self.nb, self.nb, self.bs, self.bs, dtype=tiles.dtype,
                        device=tiles.device)
        g[self.src.to(g.device), self.tgt.to(g.device)] = tiles
        d = g.permute(0, 2, 1, 3).reshape(self.nb * self.bs, self.nb * self.bs)
        return d[:self.n, :self.n]


def masks_to_tiles(state: dict, tiles: Tiles, K: int) -> dict:
    """A dense-mask state in the program's tile-resident layout: each
    block's ``mask.{k}`` become one ``mask_tiles`` (A, K, BS, BS)."""
    out = {k: v for k, v in state.items() if ".cheb_conv_SAt.mask." not in k}
    blocks = sorted({k.split(".cheb_conv_SAt.mask.")[0] for k in state
                     if ".cheb_conv_SAt.mask." in k})
    for b in blocks:
        out[b + ".cheb_conv_SAt.mask_tiles"] = torch.stack(
            [tiles.to_tiles(state[f"{b}.cheb_conv_SAt.mask.{k}"]) for k in range(K)], dim=1)
    return out


def tiles_to_masks(state: dict, tiles: Tiles, base: dict | None = None) -> dict:
    """The inverse of :func:`masks_to_tiles`: ``mask_tiles`` back to dense
    ``mask.{k}``: ``base``'s masks (a dense-mask state) off the support, or
    zero where there is no ``base``."""
    out = {}
    for name, v in state.items():
        if name.endswith(".cheb_conv_SAt.mask_tiles"):
            b = name[:-len("mask_tiles")]
            for k in range(v.shape[1]):
                dense = tiles.to_dense(v[:, k])
                if base is not None:
                    off = tiles.to_dense(torch.ones_like(v[:, k])) == 0
                    dense = torch.where(off, base[f"{b}mask.{k}"].to(dense.device), dense)
                out[f"{b}mask.{k}"] = dense
        else:
            out[name] = v
    return out
