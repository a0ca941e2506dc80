"""DSTAGNN model, dense and block-sparse (BELL) branches — PyTorch
counterpart of ``dstagnn_drought_tpu/models/dstagnn.py``.

A stack of ST blocks, each = temporal embedding → temporal multi-head
attention with score residuals → 1×F "pre conv" down to d_model → spatial
embedding → spatial attention scores → attention-modulated K-order Chebyshev
graph conv → 3/5/7-kernel gated temporal convs → linear time fusion →
residual + LayerNorm; block outputs are concatenated along time and go
through a final conv + linear head to the prediction horizon.

The modules are parameter holders named after the reference's
``state_dict`` keys, so ``import_torch_state_dict`` of the JAX package reads
a port ``state_dict`` unchanged and :func:`params_from_jax` maps the other
way. The forward is written with the JAX package's layouts and does what
its ``_block_apply``/``apply`` do on the dense branch, on the BELL
branch (``bell``: a :class:`~dstagnn_drought_tpu_torch.ops.block_sparse.
BlockEllGraph`) and on the ELL branch (``ell``: an
:class:`~dstagnn_drought_tpu_torch.ops.sparse.EllGraph`; edge SDDMM and
neighbourhood softmax, the dense masks gathered at the edges), including
the fixed multichannel residual, the ``res_att`` mean when the feature
width changes, and the ``pinned_out`` tail switch
(kernel output and T >= 48 → the (B, N, C, T) GTU tail). The BELL branch has
three spatial paths: tile-resident masks (``mask_tiles``, built with
``make_model(bell=...)``) through the tiles kernel; dense masks with
``use_pallas`` through the fused kernel; otherwise the plain block-sparse
path. ``fuse_tat`` takes the temporal attention through the fused TAt
kernels on every path; ``fuse_spatial`` takes the dense spatial middle
through the fused spatial kernels (ignored on the BELL and ELL branches,
as in JAX; ``use_pallas`` is ignored on ELL too);
``fuse_gtu`` takes the GTU tail through the fused GTU kernels on every path
where their shape gate holds, whatever ``pinned_out`` is. On a mesh the
forward's ``halo`` (JAX's: ``(mesh, plan)`` or ``(mesh, plan, overlap
lists)``) takes the spatial conv through the node-partitioned convs of
``parallel/`` (the block's ``mask_tiles`` then this rank's (A_loc, K, BS,
BS) slice), ``rows`` (``parallel.sharding.NodeRows``) keeps the node axis
sharded over 'graph' on those paths and on the dense path: x, every block
output and the prediction hold this rank's rows. What needs the whole node
axis runs whole, as one device runs it, inside a node-row region
(``NodeRows.region``: its inputs gathered, its node-axis outputs cut to the
rank's rows, only the rows of its inputs kept for the backward, where it
runs again): EmbedT, the TAt and the pre-conv (:meth:`STBlock.front`; a
split of their contractions over N or T·F rounds otherwise); on the dense
path also the SAt scores and the Chebyshev conv (:meth:`STBlock.dense_conv`)
or, with ``fuse_spatial``, the TAt and the fused spatial middle in one
region (:meth:`STBlock.fused_middle`). Everything between and after the
regions (EmbedS, dropout, the partitioned conv, the GTU tail, the residual,
the LayerNorm, the head) runs on the rank's rows; ``tp``
(``parallel.sharding.TensorParallel``) takes the TAt through this rank's
weight slices.
bfloat16 compute casts parameters and inputs at the top of the
forward, as the JAX ``apply`` does; no autocast.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dstagnn_drought_tpu_torch.device import resolve_device
from dstagnn_drought_tpu_torch.models.layers import init_like_reference_, tensor_from_jax
from dstagnn_drought_tpu_torch.ops.attention import (
    spatial_attention_scores,
    temporal_attention,
)
from dstagnn_drought_tpu_torch.ops.block_sparse import (
    block_sparse_cheb_conv_with_sat,
    block_sparse_spatial_attention_scores,
    build_bell_tile_constants,
    gather_block_values,
)
from dstagnn_drought_tpu_torch.ops.cheb import cheb_conv_with_sat
from dstagnn_drought_tpu_torch.ops.cuda.bell_fused import (
    bell_cheb_conv_tiles,
    bell_cheb_conv_with_sat_pallas,
)
from dstagnn_drought_tpu_torch.ops.cuda.block_spatial_fused import fused_spatial_middle
from dstagnn_drought_tpu_torch.ops.cuda.cheb_sat import cheb_conv_with_sat_pallas
from dstagnn_drought_tpu_torch.ops.cuda.gtu_fused import (
    gtu_fcmy,
    supported as gtu_fused_supported,
)
from dstagnn_drought_tpu_torch.ops.cuda.tat_fused import fused_temporal_attention
from dstagnn_drought_tpu_torch.ops.graph import cheb_polynomials, scaled_laplacian
from dstagnn_drought_tpu_torch.ops.gtu import (
    _IM2COL_MIN_T,
    conv2d_nchw,
    gtu,
    gtu_bnct,
)
from dstagnn_drought_tpu_torch.ops.nn import dropout, layer_norm
from dstagnn_drought_tpu_torch.ops.sparse import (
    gather_edge_values,
    sparse_cheb_conv_with_sat,
    sparse_spatial_attention_scores,
)
from dstagnn_drought_tpu_torch.parallel.bell_partition import (
    BellShardPlan,
    BellTileShardPlan,
    partitioned_bell_conv,
    partitioned_bell_tiles_conv,
    partitioned_bell_tiles_conv_overlap,
)
from dstagnn_drought_tpu_torch.parallel.graph_partition import halo_partitioned_sparse_conv
from dstagnn_drought_tpu_torch.parallel.sharding import recomputed


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model hyperparameters."""

    num_of_vertices: int
    len_input: int
    num_for_predict: int
    num_of_d: int  # input feature count (reference: in_channels doubles as num_of_d)
    nb_block: int = 4
    in_channels: int = 1
    K: int = 3
    nb_chev_filter: int = 32
    nb_time_filter: int = 32
    time_strides: int = 1
    d_model: int = 512
    d_k: int = 32
    d_v: int = -1
    n_heads: int = 3
    dropout_rate: float = 0.05

    def __post_init__(self):
        if self.d_v < 0:
            object.__setattr__(self, "d_v", self.d_k)

    @property
    def block_specs(self):
        """(num_of_d, in_channels) per block: block 1 consumes the raw input,
        later blocks consume (B, N, nb_time_filter, T)."""
        first = (self.num_of_d, self.in_channels)
        rest = (self.nb_time_filter, self.nb_chev_filter)
        return [first] + [rest] * (self.nb_block - 1)

    @classmethod
    def from_config(cls, cfg) -> "ModelSpec":
        t, d = cfg.training, cfg.data
        return cls(
            num_of_vertices=d.num_of_vertices,
            len_input=d.len_input,
            num_for_predict=d.num_for_predict,
            num_of_d=t.in_channels,
            nb_block=t.nb_block,
            in_channels=t.in_channels,
            K=t.K,
            nb_chev_filter=t.nb_chev_filter,
            nb_time_filter=t.nb_time_filter,
            time_strides=t.time_strides,
            d_model=t.d_model,
            d_k=t.d_k,
            d_v=t.d_v,
            n_heads=t.n_heads,
            dropout_rate=t.dropout,
        )


class _Embed(nn.Module):
    def __init__(self, n_pos: int, dim: int):
        super().__init__()
        self.pos_embed = nn.Embedding(n_pos, dim)
        self.norm = nn.LayerNorm(dim)


class _TAt(nn.Module):
    def __init__(self, n: int, d_k: int, d_v: int, heads: int):
        super().__init__()
        self.W_Q = nn.Linear(n, d_k * heads, bias=False)
        self.W_K = nn.Linear(n, d_k * heads, bias=False)
        self.W_V = nn.Linear(n, d_v * heads, bias=False)
        self.fc = nn.Linear(heads * d_v, n, bias=False)
        self.layer_norm = nn.LayerNorm(n)


class _SAt(nn.Module):
    def __init__(self, d_model: int, d_k: int, K: int):
        super().__init__()
        self.W_Q = nn.Linear(d_model, d_k * K, bias=False)
        self.W_K = nn.Linear(d_model, d_k * K, bias=False)


class _ChebConvSAt(nn.Module):
    """Θ per order, and the learnable graph masks: dense ``mask.{k}`` (N, N)
    or, with ``tiles`` = (A, BS), ``mask_tiles`` (A, K, BS, BS) on the BELL
    active-tile support (a port-only state_dict key)."""

    def __init__(self, K: int, c_in: int, c_out: int, n: int, tiles=None):
        super().__init__()
        self.Theta = nn.ParameterList(
            [nn.Parameter(torch.empty(c_in, c_out)) for _ in range(K)])
        if tiles is None:
            self.mask = nn.ParameterList(
                [nn.Parameter(torch.empty(n, n)) for _ in range(K)])
        else:
            A, BS = tiles
            self.mask_tiles = nn.Parameter(torch.empty(A, K, BS, BS))


class _GTU(nn.Module):
    def __init__(self, c: int, kernel: int, stride: int):
        super().__init__()
        self.con2out = nn.Conv2d(c, 2 * c, kernel_size=(1, kernel), stride=(1, stride))


class STBlock(nn.Module):
    """One spatial-temporal block (dense or BELL spatial branch)."""

    def __init__(self, spec: ModelSpec, num_of_d: int, in_channels: int,
                 tiles=None):
        super().__init__()
        self.spec = spec
        N, T, C = spec.num_of_vertices, spec.len_input, spec.nb_time_filter
        self.EmbedT = _Embed(T, N)
        self.TAt = _TAt(N, spec.d_k, spec.d_v, spec.n_heads)
        # torch Conv2d(T → d_model, kernel (1, F)) on (B, T, N, F)
        self.pre_conv = nn.Conv2d(T, spec.d_model, kernel_size=(1, num_of_d))
        self.EmbedS = _Embed(N, spec.d_model)
        self.SAt = _SAt(spec.d_model, spec.d_k, spec.K)
        self.cheb_conv_SAt = _ChebConvSAt(spec.K, in_channels, spec.nb_chev_filter, N,
                                          tiles)
        self.gtu3 = _GTU(C, 3, spec.time_strides)
        self.gtu5 = _GTU(C, 5, spec.time_strides)
        self.gtu7 = _GTU(C, 7, spec.time_strides)
        self.fcmy = nn.Sequential(nn.Linear(3 * T - 12, T))
        self.residual_conv = nn.Conv2d(in_channels, C, kernel_size=(1, 1),
                                       stride=(1, spec.time_strides))
        self.ln = nn.LayerNorm(C)

    def temporal(self, x, res_att, *, fuse_tat=False, tp=None):
        """EmbedT and the TAt on the whole node axis: x (B, N, F, T) →
        (TATout (B, F, T, N), the scores for the next block)."""
        spec = self.spec
        c = lambda t: t.to(x.dtype)
        F = x.shape[2]
        if F == 1:
            # EmbedT: (B,F,T,N) + the positional table, LayerNorm over N
            te = x.permute(0, 2, 3, 1) + c(self.EmbedT.pos_embed.weight)[None, None]
            TEmx = layer_norm(te, c(self.EmbedT.norm.weight), c(self.EmbedT.norm.bias))
        else:
            TEmx = x.permute(0, 2, 3, 1)  # (B, F, T, N), no embedding

        # score residual: when the feature width changes between blocks
        # (multichannel input), reduce the incoming scores over that axis
        if res_att.ndim == 5 and res_att.shape[1] not in (1, F):
            res_att = res_att.mean(dim=1, keepdim=True)

        # with fuse_tat the embedding stays outside the kernel (pos=None)
        tat = fused_temporal_attention if fuse_tat else temporal_attention
        extra = dict(pos=None, ln0_scale=None, ln0_bias=None) if fuse_tat else {}
        # tp: this rank's TAt weight slices, head-parallel where they hold
        # whole heads, else gathered whole first (the fused kernel's case)
        if tp is not None and tp.head_parallel and not fuse_tat:
            tat, extra, W = tp.attention, {}, lambda name: getattr(self.TAt, name).weight
        else:
            W = ((lambda name: getattr(self.TAt, name).weight) if tp is None
                 else functools.partial(tp.whole, self.TAt))
        return tat(
            TEmx, res_att,
            wq=c(W("W_Q")).t(), wk=c(W("W_K")).t(), wv=c(W("W_V")).t(), wo=c(W("fc")).t(),
            ln_scale=c(self.TAt.layer_norm.weight),
            ln_bias=c(self.TAt.layer_norm.bias),
            n_heads=spec.n_heads, d_k=spec.d_k, d_v=spec.d_v, **extra,
        )

    def pre_project(self, TATout):
        """The pre-conv, a per-node linear map over (T, F): TATout (B, F, T,
        N) → (B, N, d_model)."""
        c = lambda t: t.to(TATout.dtype)
        return (torch.einsum("bftn,dtf->bnd", TATout, c(self.pre_conv.weight)[:, :, 0, :])
                + c(self.pre_conv.bias))

    def front(self, x, res_att, *, fuse_tat=False, tp=None):
        """EmbedT, the TAt and the pre-conv on the whole node axis: x (B, N,
        F, T) → (x_tat (B, N, d_model), the scores for the next block)."""
        TATout, re_at = self.temporal(x, res_att, fuse_tat=fuse_tat, tp=tp)
        return self.pre_project(TATout), re_at

    def fused_middle(self, x, res_att, *, fuse_tat, tp, adj_pa, cheb_polys, deterministic,
                     generator):
        """EmbedT and the TAt, then the dense spatial middle in one kernel
        pair (pre_conv → EmbedS → dropout → SAt → Chebyshev conv; ahead of
        use_pallas, as in JAX), on the whole node axis: x (B, N, F, T) →
        (spatial_gcn (B, N, C, T), the scores for the next block)."""
        spec = self.spec
        c = lambda t: t.to(x.dtype)
        TATout, re_at = self.temporal(x, res_att, fuse_tat=fuse_tat, tp=tp)
        cheb = self.cheb_conv_SAt
        spatial_gcn = fused_spatial_middle(
            TATout, x, pre_w=c(self.pre_conv.weight), pre_b=c(self.pre_conv.bias),
            pos=c(self.EmbedS.pos_embed.weight), ln_scale=c(self.EmbedS.norm.weight),
            ln_bias=c(self.EmbedS.norm.bias), wq=c(self.SAt.W_Q.weight).t(),
            wk=c(self.SAt.W_K.weight).t(), adj_pa=adj_pa,
            masks=torch.stack([c(m) for m in cheb.mask]), cheb_polys=cheb_polys,
            thetas=torch.stack([c(t) for t in cheb.Theta]), K=spec.K, d_k=spec.d_k,
            dropout_rate=0.0 if deterministic else spec.dropout_rate, generator=generator)
        return spatial_gcn, re_at

    def dense_conv(self, SEmx, x, *, wq, wk, adj_pa, cheb_polys, masks, thetas, use_pallas):
        """The dense spatial attention scores of SEmx (B, N, d_model) and the
        attention-modulated Chebyshev conv of x (B, N, F, T) on the whole
        node axis (through the cheb_sat kernel under ``use_pallas``) →
        (spatial_gcn (B, N, C, T), the raw (B, K, N, N) scores)."""
        spec = self.spec
        STAt = spatial_attention_scores(SEmx, wq=wq, wk=wk, n_heads=spec.K, d_k=spec.d_k)
        conv = cheb_conv_with_sat_pallas if use_pallas else cheb_conv_with_sat
        return conv(x, STAt, adj_pa, cheb_polys=cheb_polys, masks=masks, thetas=thetas), STAt

    def forward(self, x, res_att, *, adj_pa, cheb_polys, deterministic,
                generator, use_pallas, bell=None, bell_tiles=None, ell=None,
                fuse_tat=False, fuse_spatial=False, fuse_gtu=False, halo=None, tp=None,
                rows=None):
        spec = self.spec
        dt = x.dtype
        c = lambda t: t.to(dt)  # parameters in the compute dtype
        F = x.shape[2]
        drop = functools.partial(_dropout, rate=spec.dropout_rate, generator=generator,
                                 deterministic=deterministic, rows=rows)
        if rows is not None:
            x = rows.zero_pads(x, 1)  # pad rows inert (they carry bias terms after a block)
        # fn on the whole node axis: on node rows, inside a region that takes
        # and returns the rank's rows on node axis 1 and the scores whole
        whole = functools.partial(_whole, rows=rows, outs=(1, None))
        # dense only, as in JAX
        fused_spatial = fuse_spatial and bell is None and ell is None
        if fused_spatial:
            middle = functools.partial(
                self.fused_middle, fuse_tat=fuse_tat, tp=tp, adj_pa=adj_pa,
                cheb_polys=cheb_polys, deterministic=deterministic, generator=generator)
            spatial_gcn, re_at = whole(middle, (x, res_att), (1, None), generator=generator)
        else:
            # the pre-conv whole too: its contraction over T·F rounds
            # otherwise at another row count, and the rounding flips ReLU
            # kinks of the conv downstream against one device
            front = functools.partial(self.front, fuse_tat=fuse_tat, tp=tp)
            x_tat, re_at = whole(front, (x, res_att), (1, None))
            pos_s = c(self.EmbedS.pos_embed.weight)
            se = x_tat + (pos_s if rows is None else rows.cut(pos_s, 0))[None]
            SEmx = drop(layer_norm(se, c(self.EmbedS.norm.weight), c(self.EmbedS.norm.bias)),
                        dim=1)
            if rows is not None:
                SEmx = rows.zero_pads(SEmx, 1)  # inert sources of the conv

        wq, wk = c(self.SAt.W_Q.weight).t(), c(self.SAt.W_K.weight).t()
        thetas = torch.stack([c(t) for t in self.cheb_conv_SAt.Theta])
        cheb = self.cheb_conv_SAt
        masks = (torch.stack([c(m) for m in cheb.mask])
                 if hasattr(cheb, "mask") else None)

        # pinned_out: the spatial output comes out of a kernel (JAX:
        # a pallas_call), which switches the tail below
        # STAt: the spatial map JAX's _block_apply returns for export; a
        # scalar zero where a kernel never materialises it
        no_map = lambda: torch.zeros((), dtype=dt, device=x.device)
        if fused_spatial:
            pinned_out = True
            STAt = no_map()
        elif halo is not None:
            # node-partitioned over the mesh's 'graph' axis (JAX's halo
            # branches): (mesh, plan) or, tile-resident with overlap,
            # (mesh, plan, overlap lists)
            STAt = no_map()
            mesh_, plan_ = halo[0], halo[1]
            if isinstance(plan_, BellTileShardPlan):
                pinned_out = True
                kw = dict(mask_tiles=c(cheb.mask_tiles), thetas=thetas, wq=wq, wk=wk,
                          n_heads=spec.K, d_k=spec.d_k)
                if len(halo) > 2:
                    spatial_gcn = partitioned_bell_tiles_conv_overlap(
                        mesh_, SEmx, x, plan_, halo[2], **kw)
                else:
                    spatial_gcn = partitioned_bell_tiles_conv(mesh_, SEmx, x, plan_, **kw)
            elif isinstance(plan_, BellShardPlan):
                pinned_out = True
                spatial_gcn = partitioned_bell_conv(
                    mesh_, SEmx, x, plan_, adj_pa=adj_pa, masks=masks, cheb_polys=cheb_polys,
                    thetas=thetas, wq=wq, wk=wk, n_heads=spec.K, d_k=spec.d_k)
            else:
                pinned_out = False
                spatial_gcn = halo_partitioned_sparse_conv(
                    mesh_, SEmx, x, plan_, cheb_edges=gather_edge_values(cheb_polys, ell),
                    bias_edges=gather_edge_values(adj_pa[None] * masks, ell), thetas=thetas,
                    wq=wq, wk=wk, n_heads=spec.K, d_k=spec.d_k)
        elif ell is not None:
            # edge list: SDDMM edge scores (the map JAX exports as STAt) and
            # the neighbourhood-softmax aggregation; use_pallas is ignored
            pinned_out = False
            STAt = sparse_spatial_attention_scores(SEmx, ell, wq=wq, wk=wk, n_heads=spec.K,
                                                   d_k=spec.d_k)
            spatial_gcn = sparse_cheb_conv_with_sat(
                x, STAt, ell, cheb_edges=gather_edge_values(cheb_polys, ell),
                bias_edges=gather_edge_values(adj_pa[None] * masks, ell), thetas=thetas)
        elif bell is None:
            pinned_out = use_pallas
            conv = functools.partial(self.dense_conv, wq=wq, wk=wk, adj_pa=adj_pa,
                                     cheb_polys=cheb_polys, masks=masks, thetas=thetas,
                                     use_pallas=use_pallas)
            spatial_gcn, STAt = whole(conv, (SEmx, x), (1, 1))  # (B, N, C, T)
        elif masks is None:
            # tile-resident masks: always the tiles kernel
            if bell_tiles is None:
                raise ValueError(
                    "the model has tile-resident masks (mask_tiles) but no "
                    "bell_tiles constants were given; build them with "
                    "ops.block_sparse.build_bell_tile_constants()")
            pinned_out = True
            STAt = no_map()
            spatial_gcn = bell_cheb_conv_tiles(
                x, SEmx, bell, wq=wq, wk=wk, mask_tiles=c(cheb.mask_tiles),
                pattern_tiles=bell_tiles["pattern_tiles"],
                pa_tiles=bell_tiles["pa_tiles"], cheb_tiles=bell_tiles["cheb_tiles"],
                thetas=thetas, n_heads=spec.K, d_k=spec.d_k)
        elif use_pallas:
            pinned_out = True
            STAt = no_map()
            spatial_gcn = bell_cheb_conv_with_sat_pallas(
                x, SEmx, bell, wq=wq, wk=wk, adj_pa=adj_pa, masks=masks,
                cheb_polys=cheb_polys, thetas=thetas, n_heads=spec.K, d_k=spec.d_k)
        else:
            pinned_out = False
            block_scores = block_sparse_spatial_attention_scores(
                SEmx, bell, wq=wq, wk=wk, n_heads=spec.K, d_k=spec.d_k)
            STAt = block_scores  # (B, K, NJ, S, BS, BS)
            spatial_gcn = block_sparse_cheb_conv_with_sat(
                x, block_scores, bell,
                cheb_blocks=gather_block_values(cheb_polys, bell),
                bias_blocks=gather_block_values(adj_pa[None] * masks, bell),
                thetas=thetas)

        gtus = (self.gtu3, self.gtu5, self.gtu7)
        fcmy = self.fcmy[0]
        # fuse_gtu: the fused GTU kernels where their static shape gate
        # holds (stride 1, T >= 48, 16 | T, 16 | C), as in JAX; elsewhere
        # the unfused tail below, with the same numbers
        fuse_gtu = fuse_gtu and gtu_fused_supported(
            spec.nb_time_filter, spatial_gcn.shape[-1], spec.time_strides)
        # a kernel's output feeds the (B, N, C, T) tail at long T, as the
        # JAX package's pinned_out/tail_bnct switch does
        if fuse_gtu or (pinned_out and spec.time_strides == 1
                        and spatial_gcn.shape[-1] >= _IM2COL_MIN_T):
            if fuse_gtu:
                wb = [c(t) for g in gtus for t in (g.con2out.weight, g.con2out.bias)]
                time_conv = gtu_fcmy(spatial_gcn, *wb, c(fcmy.weight).t(),
                                     c(fcmy.bias))  # (B, N, C, T)
            else:
                cat = torch.cat(
                    [gtu_bnct(spatial_gcn, c(g.con2out.weight), c(g.con2out.bias),
                              in_channels=spec.nb_time_filter) for g in gtus],
                    dim=2,
                )  # (B, N, 3T-12, C)
                time_conv = (torch.einsum("bnmc,tm->bnct", cat, c(fcmy.weight))
                             + c(fcmy.bias))  # (B, N, C, T)
            time_conv = drop(time_conv, dim=1)
            if F == 1:
                time_conv_output = torch.relu(time_conv)
            else:
                time_conv_output = torch.relu(spatial_gcn + time_conv)
            if F == spec.nb_time_filter:
                x_residual = x
            else:
                x_residual = (
                    torch.einsum("bnft,cf->bnct", x,
                                 c(self.residual_conv.weight)[:, :, 0, 0])
                    + c(self.residual_conv.bias)[None, None, :, None]
                )
            y = torch.relu(x_residual + time_conv_output)  # (B, N, C, T)
            y = layer_norm(y.permute(0, 3, 1, 2), c(self.ln.weight), c(self.ln.bias))
            return y.permute(0, 2, 3, 1), re_at, STAt  # (B, N, C, T)

        X = spatial_gcn.permute(0, 2, 1, 3)  # (B, C, N, T)
        time_conv = torch.cat(
            [gtu(X, c(g.con2out.weight), c(g.con2out.bias),
                 in_channels=spec.nb_time_filter, time_strides=spec.time_strides)
             for g in gtus],
            dim=-1,
        )  # (B, C, N, 3T-12)
        time_conv = time_conv @ c(fcmy.weight).t() + c(fcmy.bias)
        time_conv = drop(time_conv, dim=2)
        if F == 1:
            time_conv_output = torch.relu(time_conv)
        else:
            time_conv_output = torch.relu(X + time_conv)
        if F == spec.nb_time_filter:
            x_residual = x.permute(0, 2, 1, 3)  # identity residual
        else:
            # F == 1 reference path; also the fix for the reference's
            # multichannel residual-shape defect
            x_residual = conv2d_nchw(
                x.permute(0, 2, 1, 3), c(self.residual_conv.weight),
                c(self.residual_conv.bias), stride=(1, spec.time_strides),
            )
        y = torch.relu(x_residual + time_conv_output)  # (B, C, N, T)
        y = layer_norm(y.permute(0, 3, 2, 1), c(self.ln.weight), c(self.ln.bias))
        return y.permute(0, 2, 3, 1), re_at, STAt  # (B, N, C, T)


def _whole(fn, args, dims, *, rows, outs, generator=None):
    """``fn(*args)``, a function of whole node axes; on node rows
    (``rows``) inside a region of ``rows`` (``NodeRows.region``: ``dims``
    and ``outs`` the node axes of ``args`` and of ``fn``'s outputs)."""
    if rows is None:
        return fn(*args)
    return rows.region(fn, args, dims, outs, generator=generator)


def _dropout(t, *, rate, generator, deterministic, rows, dim):
    """:func:`~dstagnn_drought_tpu_torch.ops.nn.dropout` of ``t``, whose node
    axis is ``dim``; on a rank's node rows (``rows``) the mask is drawn at
    the whole node count, as one device draws it, and the rank's rows kept,
    so the graph ranks keep the single-device bits."""
    if rows is None:
        return dropout(t, rate, generator, deterministic)
    shape = list(t.shape)
    shape[dim] = rows.n
    return dropout(t, rate, generator, deterministic,
                   whole=(shape, functools.partial(rows.cut, dim=dim)))


class RematReplay:
    """The dropout replay of remat's recompute inside a CUDA graph.

    Outside a capture :func:`checkpoint_block` rewinds the generator by its
    host state (``get_state``/``set_state``), which a capture refuses: there
    the state advances on the card at each replay. Inside one, block ``i``'s
    recompute draws from ``generators[i]``, a generator of its own that the
    runner registers with the graph (``generators``) and sets before every
    replay (:meth:`arm`) to where block ``i``'s forward draws from: the
    step's start plus ``starts[i]``, the offset at which the block's forward
    began, read in an eager step of the same shapes (the runner's warm-up;
    made right before it, this object takes the step's start from the
    generator)."""

    def __init__(self, generator: torch.Generator, n_blocks: int):
        self.generator = generator
        self.origin = generator.get_offset()
        self.starts = [None] * n_blocks
        self.generators = [generator.clone_state() for _ in range(n_blocks)]

    def arm(self) -> None:
        """Before a replay: each block's generator at its forward's start."""
        base = self.generator.get_offset()
        for g, start in zip(self.generators, self.starts):
            g.set_offset(base + start)


def checkpoint_block(block: STBlock, x, res_att, *, generator=None, replay=None, **kw):
    """``block(x, res_att, ...)`` under ``torch.utils.checkpoint`` (JAX:
    ``jax.checkpoint`` of the block): its activations are recomputed in the
    backward instead of kept. Dropout draws from ``generator``, never from
    the global generators (``checkpoint`` leaves those alone); so the
    recompute starts from the state the forward started from, and draws the
    forward's masks, and the state the forward left is put back after it, so
    the stream after a step does not depend on remat. ``replay`` (a
    :class:`RematReplay` and this block's index) records the block's start
    in an eager step and, under CUDA-graph capture, gives the recompute its
    generator; a capture without it raises."""
    fn = functools.partial(block, generator=generator, **kw)
    if generator is None or not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        if generator is not None and replay is not None:
            replay[0].starts[replay[1]] = generator.get_offset() - replay[0].origin
        return recomputed(fn, x, res_att, generator=generator)
    if replay is None:
        raise RuntimeError("remat with dropout inside a CUDA graph needs a RematReplay")
    main, again = generator.graphsafe_get_state(), replay[0].generators[replay[1]]
    runs = []

    def run(x, res_att):
        if not runs:
            runs.append(True)
            return fn(x, res_att)
        generator.graphsafe_set_state(again)  # the recompute, during the backward
        try:
            return fn(x, res_att)
        finally:
            generator.graphsafe_set_state(main)

    return checkpoint(run, x, res_att, use_reentrant=False, preserve_rng_state=False)


class DSTAGNN(nn.Module):
    """x: (B, N, F, T) → (B, N, num_for_predict) float32. With ``bell`` (a
    BlockEllGraph) every block holds tile-resident masks on its active-tile
    support instead of dense (N, N) masks. The forward's ``ell`` (an
    EllGraph) takes the edge-list branch on the dense masks. ``remat``
    recomputes each block's activations in the backward
    (:func:`checkpoint_block`); ``return_attention`` also returns the list
    of per-block spatial maps: raw (B, K, N, N) scores on the dense path
    (with or without ``use_pallas``), (B, K, N, E) edge scores on ELL,
    (B, K, NJ, S, BS, BS) block scores on plain BELL, a scalar zero where a
    kernel never materialises them (fused spatial, BELL tiles, BELL with
    ``use_pallas``), as JAX's ``apply(return_attention=True)``."""

    def __init__(self, spec: ModelSpec, bell=None):
        super().__init__()
        self.spec = spec
        tiles = None if bell is None else (bell.num_active, bell.block_size)
        self.BlockList = nn.ModuleList(
            [STBlock(spec, nd, ic, tiles) for nd, ic in spec.block_specs])
        T_cat = (spec.len_input // spec.time_strides) * spec.nb_block
        self.final_conv = nn.Conv2d(T_cat, 128, kernel_size=(1, spec.nb_time_filter))
        self.final_fc = nn.Linear(128, spec.num_for_predict)

    def forward(self, x, *, adj_pa, cheb_polys, deterministic: bool = True,
                generator: torch.Generator | None = None,
                compute_dtype: torch.dtype = torch.float32,
                use_pallas: bool = False, bell=None, bell_tiles=None, ell=None,
                fuse_tat: bool = False, fuse_spatial: bool = False,
                fuse_gtu: bool = False, remat: bool | RematReplay = False,
                return_attention: bool = False, halo=None, tp=None, rows=None):
        if bell is not None and ell is not None:
            raise ValueError("give the BELL graph (bell) or the ELL graph (ell), not both")
        if rows is not None and halo is None and (bell is not None or ell is not None):
            raise ValueError("node rows (rows) on the BELL or ELL path need a "
                             "node-partitioned conv (halo)")
        x = x.to(compute_dtype)
        adj_pa = adj_pa.to(compute_dtype)
        cheb_polys = cheb_polys.to(compute_dtype)
        c = lambda t: t.to(compute_dtype)
        res_att = torch.zeros((), dtype=x.dtype, device=x.device)
        kw = dict(adj_pa=adj_pa, cheb_polys=cheb_polys, deterministic=deterministic,
                  use_pallas=use_pallas, bell=bell, bell_tiles=bell_tiles, ell=ell,
                  fuse_tat=fuse_tat, fuse_spatial=fuse_spatial, fuse_gtu=fuse_gtu,
                  halo=halo, tp=tp, rows=rows)
        outs, maps = [], []
        for i, block in enumerate(self.BlockList):
            if remat and torch.is_grad_enabled():
                replay = {"replay": (remat, i)} if isinstance(remat, RematReplay) else {}
                x, res_att, stat = checkpoint_block(block, x, res_att, generator=generator,
                                                    **replay, **kw)
            else:
                x, res_att, stat = block(x, res_att, generator=generator, **kw)
            outs.append(x)
            if return_attention:
                maps.append(stat)
        final_x = torch.cat(outs, dim=-1)  # (B, N, C, T·nb_block)
        # final_conv: Conv2d(T·nb → 128, kernel (1, C))
        out1 = (torch.einsum("bnct,dtc->bnd", final_x,
                             c(self.final_conv.weight)[:, :, 0, :])
                + c(self.final_conv.bias))
        out = (out1 @ c(self.final_fc.weight).t() + c(self.final_fc.bias)).float()
        return (out, maps) if return_attention else out


def make_model(spec: ModelSpec, adj_merge, adj_pa, *, seed: int = 0,
               device: torch.device | str = "cuda", bell=None):
    """Build (model, constants): scaled Laplacian of the merged graph → K
    Chebyshev polynomials as constants, and a model initialized like the
    reference from ``torch.Generator`` seed ``seed`` (drawn on the CPU, so
    the weights do not depend on the device). ``device`` defaults to
    ``cuda`` and raises without a card.

    With ``bell`` (a BlockEllGraph) the masks are tile-resident: each block's
    ``mask_tiles`` (A, K, BS, BS) is drawn uniform with the dense xavier
    bound √(6 / 2N), and the constants carry the per-tile adj_pa and
    Chebyshev values (``bell_tiles``) with (K, 1, 1) and (1, 1) zero
    placeholders for the dense planes, so nothing O(N²) is on the device."""
    device = resolve_device(device)
    L_tilde = scaled_laplacian(torch.as_tensor(np.asarray(adj_merge), dtype=torch.float32))
    polys = cheb_polynomials(L_tilde, spec.K)
    if bell is None:
        constants = {
            "cheb_polys": polys.to(device),
            "adj_pa": torch.as_tensor(np.asarray(adj_pa), dtype=torch.float32).to(device),
        }
    else:
        constants = {
            "cheb_polys": torch.zeros((spec.K, 1, 1), device=device),
            "adj_pa": torch.zeros((1, 1), device=device),
            "bell_tiles": build_bell_tile_constants(bell, adj_pa, polys.numpy(),
                                                    device=device),
        }
    model = DSTAGNN(spec, bell=bell)
    gen = torch.Generator().manual_seed(seed)
    init_like_reference_(model, gen)
    if bell is not None:
        bound = (6.0 / (2 * spec.num_of_vertices)) ** 0.5
        with torch.no_grad():
            for block in model.BlockList:
                block.cheb_conv_SAt.mask_tiles.uniform_(-bound, bound, generator=gen)
    return model.to(device), constants


# ---------------------------------------------------------------------------
# weights carried across from the JAX package
# ---------------------------------------------------------------------------

def params_from_jax(params, spec: ModelSpec) -> dict[str, torch.Tensor]:
    """The inverse of the JAX package's ``import_torch_state_dict``: a JAX
    parameter pytree (numpy-convertible leaves) → this model's state_dict.
    ELL weights carry over unchanged: the ELL branch keeps the dense (K, N,
    N) masks as parameters (``mask.{k}``) and gathers them at the edges. A
    partitioned JAX trainer's ``mask_tiles`` (P, A_loc, K, BS, BS) carry
    over whole, the layout of a mesh Trainer's checkpoint; its
    ``load_model_state`` takes each rank's slice."""

    t = tensor_from_jax
    sd = {}
    for i, b in enumerate(params["blocks"]):
        pre = f"BlockList.{i}."
        sd[pre + "EmbedT.pos_embed.weight"] = t(b["embed_t"]["pos"])
        sd[pre + "EmbedT.norm.weight"] = t(b["embed_t"]["ln_scale"])
        sd[pre + "EmbedT.norm.bias"] = t(b["embed_t"]["ln_bias"])
        sd[pre + "TAt.W_Q.weight"] = t(b["tat"]["wq"], True)
        sd[pre + "TAt.W_K.weight"] = t(b["tat"]["wk"], True)
        sd[pre + "TAt.W_V.weight"] = t(b["tat"]["wv"], True)
        sd[pre + "TAt.fc.weight"] = t(b["tat"]["wo"], True)
        sd[pre + "TAt.layer_norm.weight"] = t(b["tat"]["ln_scale"])
        sd[pre + "TAt.layer_norm.bias"] = t(b["tat"]["ln_bias"])
        sd[pre + "pre_conv.weight"] = t(b["pre_conv"]["w"])
        sd[pre + "pre_conv.bias"] = t(b["pre_conv"]["b"])
        sd[pre + "EmbedS.pos_embed.weight"] = t(b["embed_s"]["pos"])
        sd[pre + "EmbedS.norm.weight"] = t(b["embed_s"]["ln_scale"])
        sd[pre + "EmbedS.norm.bias"] = t(b["embed_s"]["ln_bias"])
        sd[pre + "SAt.W_Q.weight"] = t(b["sat"]["wq"], True)
        sd[pre + "SAt.W_K.weight"] = t(b["sat"]["wk"], True)
        for k in range(spec.K):
            sd[pre + f"cheb_conv_SAt.Theta.{k}"] = t(np.asarray(b["cheb"]["thetas"])[k])
        if "mask_tiles" in b["cheb"]:
            sd[pre + "cheb_conv_SAt.mask_tiles"] = t(b["cheb"]["mask_tiles"])
        else:
            for k in range(spec.K):
                sd[pre + f"cheb_conv_SAt.mask.{k}"] = t(np.asarray(b["cheb"]["masks"])[k])
        for ksz in (3, 5, 7):
            sd[pre + f"gtu{ksz}.con2out.weight"] = t(b[f"gtu{ksz}"]["w"])
            sd[pre + f"gtu{ksz}.con2out.bias"] = t(b[f"gtu{ksz}"]["b"])
        sd[pre + "fcmy.0.weight"] = t(b["fcmy"]["w"], True)
        sd[pre + "fcmy.0.bias"] = t(b["fcmy"]["b"])
        sd[pre + "residual_conv.weight"] = t(b["residual_conv"]["w"])
        sd[pre + "residual_conv.bias"] = t(b["residual_conv"]["b"])
        sd[pre + "ln.weight"] = t(b["ln"]["scale"])
        sd[pre + "ln.bias"] = t(b["ln"]["bias"])
    sd["final_conv.weight"] = t(params["final_conv"]["w"])
    sd["final_conv.bias"] = t(params["final_conv"]["b"])
    sd["final_fc.weight"] = t(params["final_fc"]["w"], True)
    sd["final_fc.bias"] = t(params["final_fc"]["b"])
    return sd


def permute_nodes(state_dict: dict, perm) -> dict:
    """A dense-mask state_dict with every node-indexed axis reordered by
    ``perm`` (new node i is old node perm[i]): the positional tables, the
    temporal-attention weights whose token width is N, their LayerNorms and
    the (N, N) masks. The model with these weights on inputs and graphs
    permuted by ``perm`` computes the permuted function."""
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.long)
    out = {}
    for k, v in state_dict.items():
        if k.endswith(("EmbedT.pos_embed.weight", "TAt.W_Q.weight", "TAt.W_K.weight",
                       "TAt.W_V.weight")):
            v = v[:, perm]
        elif k.endswith(("EmbedT.norm.weight", "EmbedT.norm.bias", "TAt.fc.weight",
                         "TAt.layer_norm.weight", "TAt.layer_norm.bias",
                         "EmbedS.pos_embed.weight")):
            v = v[perm]
        elif ".cheb_conv_SAt.mask." in k:
            v = v[perm][:, perm]
        elif k.endswith("cheb_conv_SAt.mask_tiles"):
            raise ValueError("tile-resident masks follow their graph's tiling; "
                             "permute a dense-mask model")
        out[k] = v.clone()
    return out


def constants_from_jax(constants) -> dict:
    """The JAX package's ``cheb_polys``/``adj_pa`` constants (and its
    ``bell_tiles``, when present) as CPU tensors."""
    out = {
        name: torch.from_numpy(np.array(constants[name], dtype=np.float32))
        for name in ("cheb_polys", "adj_pa")
    }
    if "bell_tiles" in constants:
        out["bell_tiles"] = {k: torch.from_numpy(np.array(v))
                             for k, v in constants["bell_tiles"].items()}
    return out
