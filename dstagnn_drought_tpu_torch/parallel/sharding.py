"""Parameter and batch slices of a rank, and tensor-parallel temporal
attention.

Counterpart of ``dstagnn_drought_tpu/parallel/sharding.py``. JAX places
arrays with ``NamedSharding``s and lets GSPMD derive the program; here the
placements are the slices a rank holds:

  * :func:`batch_sharding` — the rows ``[d·B/D, (d+1)·B/D)`` of each global
    batch that data rank d takes (JAX: ``P('data', ...)``);
  * :class:`NodeRows` — on the partitioned spatial paths and the dense
    path, the node rows ``[g·Np/P, (g+1)·Np/P)`` of the padded node axis
    that graph rank g holds from the batch to the loss (JAX:
    ``constrain_batch``'s ``P('data', 'graph')``); what needs the whole
    node axis runs whole inside a region (:meth:`NodeRows.region`), which
    keeps only the rows of its inputs for the backward; the parameters used
    on the rows only have their gradients summed over 'graph'; every other
    tensor is whole on every rank (JAX's ``replicated``);
  * :func:`tat_tp_shardings` — with ``tp``, the axis each TAt weight is
    split on over 'graph' (wq/wk/wv on their output H·d axis, wo on its
    input H·d axis), with JAX's logged fallback to the whole weight where
    the axis does not divide; :func:`tp_report` — JAX's byte accounting,
    which the Trainer logs under ``tp``.

:class:`TensorParallel` computes the temporal attention from the slices:
head-parallel where every weight is split and each rank's slice holds whole
heads (the Megatron pair of :mod:`~dstagnn_drought_tpu_torch.parallel.comm`
around it), else with the slices gathered into whole weights first, which is
what GSPMD does for the fused TAt kernel under ``tp`` (a ``pallas_call``
takes whole operands).
"""
from __future__ import annotations

import logging
import re

import torch
from torch.utils.checkpoint import checkpoint

from dstagnn_drought_tpu_torch.ops.attention import _sqrt
from dstagnn_drought_tpu_torch.ops.nn import layer_norm
from dstagnn_drought_tpu_torch.parallel import comm
from dstagnn_drought_tpu_torch.parallel.graph_partition import pad_nodes

logger = logging.getLogger(__name__)

# torch weight names of the TAt projections and the axis their H·d runs on
# (nn.Linear stores (out, in): JAX's wq (N, H·d) split on its last axis is
# W_Q.weight (H·d, N) split on axis 0; JAX's wo (H·d, N) split on axis 0 is
# fc.weight (N, H·d) split on axis 1)
_TAT = {"W_Q": 0, "W_K": 0, "W_V": 0, "fc": 1}
_TAT_NAME = re.compile(r"(^|\.)TAt\.(W_Q|W_K|W_V|fc)\.weight$")
_JAX_NAME = {"W_Q": "wq", "W_K": "wk", "W_V": "wv", "fc": "wo"}


def batch_sharding(mesh, batch_size: int) -> slice:
    """This data rank's rows of a global batch of ``batch_size``."""
    if batch_size % mesh.data:
        raise ValueError(f"batch_size={batch_size} must divide over data_axis={mesh.data}")
    rows = batch_size // mesh.data
    return slice(mesh.d * rows, (mesh.d + 1) * rows)


def recomputed(fn, *args, generator=None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant, the
    global RNG states left alone): only ``args`` are kept for the backward,
    which runs ``fn`` again. Where ``fn`` draws dropout from ``generator``
    (never from the global generators), the recompute starts from the state
    the forward started from, and so draws the forward's masks, and the
    state the forward left is put back after it."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    start, runs = generator.get_state(), []

    def run(*a):
        if not runs:
            runs.append(True)
            return fn(*a)
        after = generator.get_state()  # the recompute, during the backward
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


# the modules computed whole on every graph rank, inside a region (EmbedT,
# the TAt, the pre-conv; on the dense path the SAt and the Chebyshev conv)
# or whose gradients the partitioned conv's collectives make whole (SAt's
# W_Q and W_K and the Chebyshev conv: Θ by copy_to, the dense masks by
# enter, the mask_tiles a slice); every other parameter is used on a rank's
# rows only
_WHOLE_GRAD = ("EmbedT", "TAt", "pre_conv", "SAt", "cheb_conv_SAt")


class NodeRows:
    """Graph rank g's rows ``[g·Np/P, (g+1)·Np/P)`` of the node axis padded
    from N to ``n_pad`` (the partitioned plan's Np, or N padded to a
    multiple of P on the dense path); rows at N and past are padding. The
    batch, every activation between the regions, the predictions and the
    loss live on these rows; EmbedT, the TAt and the pre-conv (and on the
    dense path the spatial middle) run whole inside :meth:`region`.
    ``whole`` names modules besides ``_WHOLE_GRAD`` that run whole (EmbedS
    inside the fused spatial middle's region)."""

    def __init__(self, mesh, n: int, n_pad: int, whole: tuple = ()):
        self.group, self.n, self.n_pad = mesh.graph_group, n, n_pad
        self.nloc = n_pad // mesh.graph
        self.lo = mesh.g * self.nloc
        self.held = max(0, min(self.nloc, n - self.lo))  # true rows this rank holds
        self._whole_grad = re.compile(r"(^|\.)(%s)\." % "|".join(_WHOLE_GRAD + tuple(whole)))

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a whole tensor, zero where they are padding
        (no collective)."""
        return pad_nodes(t.narrow(dim, min(self.lo, self.n), self.held), dim, self.nloc)

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a tensor whole and alike on every rank of the
        group (backward: all-gather)."""
        return comm.enter(pad_nodes(t, dim, self.n_pad), dim, self.group)

    def whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor (N rows) from every rank's rows (backward: this
        rank's rows)."""
        return comm.leave(t, dim, self.group).narrow(dim, 0, self.n)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """:meth:`whole` without autograd (predictions)."""
        return comm.all_gather(t, dim, self.group).narrow(dim, 0, self.n)

    def region(self, fn, args: tuple, dims: tuple, outs: tuple, generator=None) -> tuple:
        """A node-row region: ``fn`` of whole tensors, computed whole as one
        device computes it, on this rank's rows. Each of ``args`` whose
        ``dims`` entry is an axis holds this rank's rows on that node axis
        and is gathered whole (:meth:`whole`); one whose entry is None is
        passed as it is. Of ``fn``'s outputs, each whose ``outs`` entry is
        an axis comes back as this rank's rows on it (:meth:`take`); one
        whose entry is None comes back whole. Only ``args`` are kept for the
        backward: the region runs again there (:func:`recomputed`, its
        gathers again, in the same order on every rank of the group, and its
        dropout, drawn from ``generator``, replayed), so the whole tensors
        inside live for a moment, not until the backward. The gradients of
        the weights used inside come out whole and alike on every rank."""
        def run(*ts):
            out = fn(*(t if d is None else self.whole(t, d) for t, d in zip(ts, dims)))
            return tuple(o if d is None else self.take(o, d) for o, d in zip(out, outs))
        return recomputed(run, *args, generator=generator)

    def zero_pads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t`` with its padding rows set to zero (they carry bias terms
        after a block; the partitioned convs take them as inert sources)."""
        if self.held == self.nloc:
            return t
        return pad_nodes(t.narrow(dim, 0, self.held), dim, self.nloc)

    def summed(self, model: torch.nn.Module) -> list:
        """The parameters used on this rank's rows only: each rank's
        gradient is its rows' share, summed over 'graph' once."""
        return [p for name, p in model.named_parameters() if not self._whole_grad.search(name)]


def tat_tp_shardings(named_params: dict, mesh) -> dict[str, int | None]:
    """{torch name: split axis or None} for every TAt projection weight of
    ``named_params`` (whole weights, e.g. ``dict(model.named_parameters())``
    of a model that holds no slices yet). A weight whose H·d axis does not
    divide by the 'graph' axis stays whole, and that fallback is logged
    once a call with the shapes, as in JAX."""
    g = mesh.shape["graph"]
    out, fallbacks = {}, []
    for name, p in named_params.items():
        m = _TAT_NAME.search(name)
        if m is None:
            continue
        axis = _TAT[m.group(2)]
        if p.shape[axis] % g == 0:
            out[name] = axis
        else:
            out[name] = None
            shape = tuple(p.shape[::-1])  # the JAX (in, out) layout
            fallbacks.append(f"{_JAX_NAME[m.group(2)]}{shape}")
    if fallbacks:
        logger.warning(
            "tat_tp_shardings: %d TAt weights fell back to REPLICATED "
            "placement (head dim not divisible by graph axis %d): %s — "
            "tensor parallelism is a no-op for these.",
            len(fallbacks), g, ", ".join(sorted(set(fallbacks))),
        )
    return out


def tp_report(named_params: dict, mesh) -> dict:
    """Per-device parameter bytes under :func:`tat_tp_shardings` (JAX's
    fields): a split TAt weight divides its bytes by the 'graph' axis,
    everything else is whole on every device."""
    g = mesh.shape["graph"]
    axes = tat_tp_shardings(named_params, mesh)
    sharded = repl = 0
    for name, p in named_params.items():
        n = p.numel() * p.element_size()
        if axes.get(name) is None:
            repl += n
        else:
            sharded += n
    total = sharded + repl
    return {
        "sharded_tat_bytes": sharded,
        "replicated_bytes": repl,
        "total_bytes": total,
        "per_device_bytes_tp": repl + sharded // g,
        "per_device_bytes_replicated": total,
        "fallback": sharded == 0,
    }


class TensorParallel:
    """The TAt of every block from this rank's weight slices (``axes``:
    :func:`tat_tp_shardings` of the whole model; every block's TAt has the
    same shapes, so one axis a projection)."""

    def __init__(self, mesh, axes: dict, n_heads: int):
        self.group = mesh.graph_group
        self.size = mesh.graph
        self.axes = {_TAT_NAME.search(name).group(2): axis for name, axis in axes.items()}
        self.head_parallel = (len(self.axes) == len(_TAT) and n_heads % self.size == 0
                              and all(a is not None for a in self.axes.values()))

    def whole(self, tat, name: str) -> torch.Tensor:
        """The whole torch weight ``name`` (W_Q, W_K, W_V or fc) of the TAt
        module ``tat``, gathered from the slices where it is split
        (backward: this rank's slice of the whole gradient, which every rank
        computes alike)."""
        w = getattr(tat, name).weight
        axis = self.axes.get(name)
        return w if axis is None else comm.leave(w, axis, self.group)

    def attention(self, x, res_att, *, wq, wk, wv, wo, ln_scale, ln_bias, n_heads, d_k,
                  d_v):
        """Head-parallel temporal attention: this rank's H/G heads from its
        column slices wq/wk/wv (N, H·d/G) and row slice wo (H·d/G, N); the
        out-projection's partial sums are all-reduced before the residual
        and the LayerNorm. Returns (out (B, F, T, N), this rank's scores
        (B, F, H/G, T, T)); the scores go on to the next block's TAt, which
        holds the same heads."""
        B, F, T, N = x.shape
        h = n_heads // self.size
        xin = comm.copy_to(x, self.group)
        qkv = xin @ torch.cat([wq, wk, wv], dim=1)
        hk = h * d_k
        q = qkv[..., :hk].reshape(B, F, T, h, d_k)
        k = qkv[..., hk:2 * hk].reshape(B, F, T, h, d_k)
        v = qkv[..., 2 * hk:].reshape(B, F, T, h, d_v)
        scores = torch.einsum("bfqhd,bfkhd->bfhqk", q, k) / _sqrt(d_k, x)
        scores = scores + res_att
        attn = torch.softmax(scores, dim=3)  # the query axis (reference quirk)
        context = torch.einsum("bfhqk,bfkhd->bfqhd", attn, v).reshape(B, F, T, h * d_v)
        out = comm.reduce_from(context @ wo, self.group)
        return layer_norm(out + x, ln_scale, ln_bias), scores


_MASK_TILES = "cheb_conv_SAt.mask_tiles"


class ParamLayout:
    """Which parameters a rank holds a slice of, and how a whole tensor and
    a rank's slice map onto each other: with a tile-resident partitioned
    plan (``tiles``), every ``mask_tiles`` is whole (P, A_loc, K, BS, BS)
    and the rank's slice is row g; with ``tp``, the TAt weights of
    ``tp_axes`` split on their axis. Everything else is whole on every
    rank. :meth:`whole` is collective over the data row."""

    def __init__(self, mesh, tp_axes: dict | None = None, tiles: bool = False):
        self.mesh, self.tiles = mesh, tiles
        self.tp_axes = {k: a for k, a in (tp_axes or {}).items() if a is not None}

    def sliced(self, name: str) -> bool:
        return (self.tiles and name.endswith(_MASK_TILES)) or name in self.tp_axes

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``name``."""
        if self.tiles and name.endswith(_MASK_TILES):
            return whole[self.mesh.g]
        if name in self.tp_axes:
            return comm.own_rows(whole, self.tp_axes[name], self.mesh.graph_group)
        return whole

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor ``name`` from every rank's slice."""
        grp = self.mesh.graph_group
        if self.tiles and name.endswith(_MASK_TILES):
            return comm.all_gather(local.contiguous()[None], 0, grp)
        if name in self.tp_axes:
            return comm.all_gather(local, self.tp_axes[name], grp)
        return local

    def whole_state(self, state: dict) -> dict:
        """A model ``state_dict`` of slices → whole tensors (collective)."""
        return {k: self.whole(k, v) for k, v in state.items()}

    def local_state(self, state: dict) -> dict:
        return {k: self.local(k, v) for k, v in state.items()}

    def _optimizer(self, state: dict, names: list, fn) -> dict:
        out = {"param_groups": state["param_groups"], "state": {}}
        for i, st in state["state"].items():
            name = names[int(i)]
            out["state"][i] = {k: fn(name, v) if torch.is_tensor(v) and v.ndim else v
                               for k, v in st.items()}
        return out

    def whole_optimizer(self, state: dict, names: list) -> dict:
        """An Adam ``state_dict`` whose moments follow the slices → whole
        moments (``names``: the parameter names in the optimizer's order)."""
        return self._optimizer(state, names, self.whole)

    def local_optimizer(self, state: dict, names: list) -> dict:
        return self._optimizer(state, names, self.local)

    def shard_(self, model: torch.nn.Module, whole: dict) -> None:
        """Replace the sliced parameters of ``model`` by this rank's slices
        of ``whole`` (a whole state_dict)."""
        for name in [n for n, _ in model.named_parameters() if self.sliced(n)]:
            owner, leaf = model, name
            if "." in name:
                path, leaf = name.rsplit(".", 1)
                owner = model.get_submodule(path)
            setattr(owner, leaf, torch.nn.Parameter(self.local(name, whole[name]).clone()))
