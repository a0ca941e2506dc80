"""Eager train / eval steps.

Counterpart of ``dstagnn_drought_tpu/training/step.py``: SmoothL1 (Huber,
beta=1) and Adam with the torch-default betas/eps (the JAX package's
``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)``). PyTorch runs eagerly, so a
step is a plain function; the losses stay on the device and the trainer
reads them once per epoch. ``constants`` carries the dense planes and, on
the sparse path, the BlockEllGraph (``bell``) and its per-tile constants
(``bell_tiles``) or the EllGraph (``ell``). ``fuse_tat``/``fuse_spatial``/
``fuse_gtu`` select the fused kernels, as the JAX trainer's ``apply_extra``
does. The steps call every model family's forward with the same keywords;
the zoo families ignore the DSTAGNN-only ones (``remat`` is passed only
when set: DSTAGNN alone takes it, as in JAX).
:func:`make_checked_train_step` is the debug-mode step.

On a mesh (:mod:`~dstagnn_drought_tpu_torch.parallel`) a step takes this
rank's rows of the global batch; ``model_kw`` carries the partitioned
paths' keywords (``halo``, ``tp``, ``rows``) to the forward, the rows'
weighted loss is divided by the global batch's weight sum
(``weight_total``), so the data ranks' losses add up to the single-device
loss, and with a ``data_group`` the gradients are summed over the group
before Adam (:func:`~dstagnn_drought_tpu_torch.parallel.comm.reduce_gradients`):
the update is the single-device step's, on every rank alike. With ``rows``
(:class:`~dstagnn_drought_tpu_torch.parallel.sharding.NodeRows`) the batch,
the prediction and the loss hold this graph rank's node rows: the loss is
the rank's share (its true rows over the whole node count), and the
gradients of the parameters used on the rows only are summed over 'graph'
first.

:func:`make_epoch_runner` and :func:`make_eval_runner` are JAX's
whole-epoch programs (a ``lax.scan`` of the step over the batch plan): on
the card each captures its step once into a CUDA graph and replays it for
every batch; on the CPU they run the same body eagerly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.models.dstagnn import RematReplay
from dstagnn_drought_tpu_torch.ops.cuda import (
    bell_bwd,
    bell_fused,
    block_spatial_fused,
    cheb_sat,
    gtu_fused,
    tat_fused,
)
from dstagnn_drought_tpu_torch.ops.nn import per_sample_smooth_l1, smooth_l1_loss
from dstagnn_drought_tpu_torch.parallel import comm


def make_optimizer(params, learning_rate: float, device=None) -> torch.optim.Adam:
    """Adam with JAX's betas and eps. On a CUDA ``device`` it is
    ``capturable`` (its step counts live on the card, so a CUDA graph can
    replay its update); the CPU refuses that, and there it is not."""
    capturable = device is not None and torch.device(device).type == "cuda"
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by name. A wrapper counts the
    calls that launched its kernel: inside a CUDA graph that is the capture,
    not the replays (the runners' ``stats`` say how often each graph ran)."""
    return {"cheb_sat": cheb_sat.launches, "bell_fused": bell_fused.launches,
            "bell_k1": bell_bwd.k1_launches, "bell_k2": bell_bwd.k2_launches,
            "tat_fwd": tat_fused.fwd_launches, "tat_bwd": tat_fused.bwd_launches,
            "spatial_fwd": block_spatial_fused.fwd_launches,
            "spatial_bwd": block_spatial_fused.bwd_launches,
            "gtu_fwd": gtu_fused.fwd_launches, "gtu_bwd": gtu_fused.bwd_launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    x: torch.Tensor,
    y: torch.Tensor,
    constants: dict,
    *,
    weights: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    fuse_tat: bool = False,
    fuse_spatial: bool = False,
    fuse_gtu: bool = False,
    remat: bool | RematReplay = False,
    model_kw: dict | None = None,
    data_group=None,
    weight_total: torch.Tensor | None = None,
) -> torch.Tensor:
    """Forward (dropout on) → weighted SmoothL1 → backward → Adam. Returns
    the loss (this rank's share of it with a ``data_group``), detached, on
    the device."""
    optimizer.zero_grad(set_to_none=True)
    pred = model(
        x, adj_pa=constants["adj_pa"], cheb_polys=constants["cheb_polys"],
        deterministic=False, generator=generator,
        compute_dtype=compute_dtype, use_pallas=use_pallas,
        bell=constants.get("bell"), bell_tiles=constants.get("bell_tiles"),
        ell=constants.get("ell"),
        fuse_tat=fuse_tat, fuse_spatial=fuse_spatial, fuse_gtu=fuse_gtu,
        **({"remat": remat} if remat else {}), **(model_kw or {}),
    )
    rows = (model_kw or {}).get("rows")
    loss = smooth_l1_loss(pred, y, sample_weights=weights, weight_total=weight_total,
                          node_rows=_node_rows(rows))
    loss.backward()
    if rows is not None:
        comm.reduce_gradients(rows.summed(model), rows.group)
    comm.reduce_gradients(model.parameters(), data_group)
    optimizer.step()
    return loss.detach()


def make_checked_train_step(**step_kw):
    """The sanitizer variant of :func:`train_step` (JAX: the ``checkify``
    step): returns ``step(model, optimizer, x_full, y_full, idx, constants,
    *, weights, generator, batch)`` → loss. ``idx`` (host numpy or a CPU
    tensor) is checked against the split's length before the gather
    (:class:`~dstagnn_drought_tpu_torch.debug.BatchIndexError`); then the
    whole step, forward, loss, backward and Adam, runs under
    :func:`~dstagnn_drought_tpu_torch.debug.checking`, so the first op or
    kernel that emits a NaN or inf raises
    :class:`~dstagnn_drought_tpu_torch.debug.NonFiniteError` naming it and
    the batch. ``step_kw`` are :func:`train_step`'s keywords. It computes
    what :func:`train_step` computes, bit for bit."""

    def step(model, optimizer, x_full, y_full, idx, constants, *, weights=None,
             generator=None, batch=None, weight_total=None):
        debug.check_batch_indices(idx, x_full.shape[0], batch)
        i = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(x_full.device)
        with debug.checking(batch):
            return train_step(model, optimizer, x_full[i], y_full[i], constants,
                              weights=weights, generator=generator,
                              weight_total=weight_total, **step_kw)

    return step


@torch.no_grad()
def eval_step(
    model: torch.nn.Module,
    x: torch.Tensor,
    y: torch.Tensor,
    constants: dict,
    *,
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    fuse_tat: bool = False,
    fuse_spatial: bool = False,
    fuse_gtu: bool = False,
    model_kw: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic forward → (pred float32, per-sample SmoothL1 (B,)); on
    node rows (``model_kw``'s ``rows``) this rank's rows of the prediction
    and its shares of the losses."""
    pred = model(
        x, adj_pa=constants["adj_pa"], cheb_polys=constants["cheb_polys"],
        deterministic=True, compute_dtype=compute_dtype, use_pallas=use_pallas,
        bell=constants.get("bell"), bell_tiles=constants.get("bell_tiles"),
        ell=constants.get("ell"),
        fuse_tat=fuse_tat, fuse_spatial=fuse_spatial, fuse_gtu=fuse_gtu,
        **(model_kw or {}),
    )
    return pred, per_sample_smooth_l1(pred, y, node_rows=_node_rows((model_kw or {}).get("rows")))


def _node_rows(rows):
    """The loss's ``node_rows`` of a NodeRows (None: the whole node axis)."""
    return None if rows is None else (rows.held, rows.n)


# ---------------------------------------------------------------------------
# whole-epoch runners
# ---------------------------------------------------------------------------

_SIDE_STREAMS: dict = {}


def _side_stream(device) -> torch.cuda.Stream:
    """The one side stream of ``device`` that every warm-up and capture
    runs on (each stream gets cuBLAS workspaces of its own, which the
    process keeps)."""
    device = torch.device(device)
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _on_side_stream(fn, device):
    """``fn()`` on the side stream, ordered after the current stream's
    work and before its next (a CUDA graph's warm-up)."""
    main, side = torch.cuda.current_stream(device), _side_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def _record(name: str, warmup: dict) -> dict:
    """A graph's entry in the runners' ``stats``: the launches of the eager
    step before its capture (the warm-up), the launches its capture counted
    (the graph's launches, which the capture itself did not run), its
    replays and its capture time."""
    return {"graph": name, "warmup": warmup, "captured": None, "replays": 0,
            "capture_ms": None}


def _capture(record: dict, fn, device, pool, generators=()):
    """``fn()`` captured on the side stream into a new CUDA graph in memory
    pool ``pool``, the ``generators`` registered with it (each replay then
    draws from their states as they stand). Returns (graph, fn's outputs,
    which the replays overwrite)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    before = launch_counts()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, stream=_side_stream(device)):
        out = fn()
    record["capture_ms"] = (time.perf_counter() - t0) * 1e3
    record["captured"] = _since(before)
    return graph, out


class EpochRunner:
    """A training epoch over a device-resident batch plan (JAX:
    :func:`make_epoch_runner`'s ``lax.scan``): ``run(x_full, y_full,
    idx_plan, weight_plan, totals)`` → the per-step losses (nb,) on the
    device; ``idx_plan`` (nb, B) int64, ``weight_plan`` (nb, B) and
    ``totals`` (nb,) on the split's device, every batch of one shape.

    On the card the first step of the runner's first epoch runs eagerly on
    a side stream (Adam makes its state there, and cuBLAS, autograd and the
    kernels initialise), then the step is captured once, on that stream,
    into a CUDA graph on static (B,) buffers, and every later step copies its plan row into
    them and replays: the gather ``x_full[idx]``, the forward, the loss,
    the backward and Adam run inside the graph. A capture runs nothing, so
    the trajectory is the eager loop's. The generator is registered with
    the graph (each replay draws where the eager step would); with
    ``remat`` so is a generator a block for the recompute's dropout
    (:class:`~dstagnn_drought_tpu_torch.models.dstagnn.RematReplay`). A
    capture that fails raises. The graph holds the addresses of the
    parameters, Adam's state and the split, and the lr as a number: after
    anything replaces one of them, make a new runner. ``stats`` (a list,
    shared with the eval runner) gets one record a graph. ``step_fn`` is
    the step it runs (:func:`train_step`).

    On the CPU the same body runs eagerly, one call a batch."""

    def __init__(self, model, optimizer, constants: dict, *, generator=None, pool=None,
                 stats: list | None = None, step_fn=None, **step_kw):
        self.model, self.optimizer, self.constants = model, optimizer, constants
        self.generator, self.pool, self.step_kw = generator, pool, step_kw
        self.step_fn = train_step if step_fn is None else step_fn
        self.stats = [] if stats is None else stats
        self._graph = None   # (graph, key, static (idx, w, total), loss, record, replay)
        self._warmup = None  # (record, replay) of the eager warm-up step

    def _step(self, x_full, y_full, idx, w, total, replay=None):
        kw = self.step_kw if replay is None else dict(self.step_kw, remat=replay)
        return self.step_fn(self.model, self.optimizer, x_full[idx], y_full[idx],
                            self.constants, weights=w, weight_total=total,
                            generator=self.generator, **kw)

    def __call__(self, x_full, y_full, idx_plan, weight_plan, totals) -> torch.Tensor:
        nb = idx_plan.shape[0]
        if x_full.device.type != "cuda":
            return torch.stack([self._step(x_full, y_full, idx_plan[b], weight_plan[b],
                                           totals[b]) for b in range(nb)])
        losses = torch.empty(nb, device=x_full.device)
        first = 0
        if self._warmup is None:
            losses[0] = self._warm_up(x_full, y_full, idx_plan[0], weight_plan[0], totals[0])
            first = 1
        for b in range(first, nb):
            if self._graph is None:
                self._capture(x_full, y_full, idx_plan[b], weight_plan[b], totals[b])
            graph, key, static, loss, record, replay = self._graph
            if key != (x_full.data_ptr(), y_full.data_ptr()):
                raise ValueError("the epoch runner's graph reads another split: make a new runner")
            for buf, row in zip(static, (idx_plan[b], weight_plan[b], totals[b])):
                buf.copy_(row)
            if replay is not None:
                replay.arm()
            graph.replay()
            record["replays"] += 1
            losses[b] = loss
        return losses

    def _warm_up(self, x_full, y_full, idx, w, total):
        replay = None
        if self.step_kw.get("remat") and self.generator is not None:
            replay = RematReplay(self.generator, len(self.model.BlockList))
        before = launch_counts()
        loss = _on_side_stream(lambda: self._step(x_full, y_full, idx, w, total, replay),
                               x_full.device)
        self._warmup = (_record("train", _since(before)), replay)
        return loss

    def _capture(self, x_full, y_full, idx, w, total):
        record, replay = self._warmup
        # the static buffers live outside the graph's pool
        static = (idx.clone(), w.clone(), total.clone())
        gens = [] if self.generator is None else [self.generator]
        gens += [] if replay is None else replay.generators
        graph, loss = _capture(record, lambda: self._step(x_full, y_full, *static, replay),
                               x_full.device, self.pool, gens)
        self.stats.append(record)
        self._graph = (graph, (x_full.data_ptr(), y_full.data_ptr()), static, loss, record,
                       replay)


class EvalRunner:
    """Evaluation over a device-resident batch plan (JAX:
    :func:`make_eval_runner`): ``run(x_full, y_full, idx_plan)`` →
    (predictions (nb, B, ...), per-sample losses (nb, B)), padded rows
    included. On the card one graph a split: the split's first pass runs
    its first batch eagerly on a side stream (the warm-up), captures, and
    replays the graph for every other batch; later passes replay it for
    every batch. On the CPU the same body runs eagerly. ``stats`` as
    :class:`EpochRunner`'s; ``step_fn`` the step it runs
    (:func:`eval_step`)."""

    def __init__(self, model, constants: dict, *, pool=None, stats: list | None = None,
                 step_fn=None, **step_kw):
        self.model, self.constants, self.pool, self.step_kw = model, constants, pool, step_kw
        self.step_fn = eval_step if step_fn is None else step_fn
        self.stats = [] if stats is None else stats
        self._graphs = {}  # (x_full, y_full) pointers → (graph, static idx, outputs, record)

    def _step(self, x_full, y_full, idx):
        return self.step_fn(self.model, x_full[idx], y_full[idx], self.constants,
                            **self.step_kw)

    def __call__(self, x_full, y_full, idx_plan) -> tuple[torch.Tensor, torch.Tensor]:
        nb = idx_plan.shape[0]
        if x_full.device.type != "cuda":
            outs = [self._step(x_full, y_full, idx_plan[b]) for b in range(nb)]
            return torch.stack([p for p, _ in outs]), torch.stack([l for _, l in outs])
        key = (x_full.data_ptr(), y_full.data_ptr())
        warm = None
        if key not in self._graphs:
            before = launch_counts()
            warm = _on_side_stream(lambda: self._step(x_full, y_full, idx_plan[0]),
                                   x_full.device)
            record = _record("eval", _since(before))
            static = idx_plan[0].clone()
            graph, out = _capture(record, lambda: self._step(x_full, y_full, static),
                                  x_full.device, self.pool)
            self.stats.append(record)
            self._graphs[key] = (graph, static, out, record)
        graph, static, (pred, per_sample), record = self._graphs[key]
        preds = pred.new_empty((nb, *pred.shape))
        losses = per_sample.new_empty((nb, *per_sample.shape))
        if warm is not None:
            preds[0], losses[0] = warm
        for b in range(0 if warm is None else 1, nb):
            static.copy_(idx_plan[b])
            graph.replay()
            record["replays"] += 1
            preds[b], losses[b] = pred, per_sample
        return preds, losses


def make_epoch_runner(model, optimizer, constants: dict, *, generator=None, pool=None,
                      stats: list | None = None, step_fn=None, **step_kw) -> EpochRunner:
    """JAX's ``make_epoch_runner``: an :class:`EpochRunner` of ``step_fn``
    (:func:`train_step`) with ``step_kw`` (its keywords); ``pool`` a CUDA
    graph memory pool (``torch.cuda.graph_pool_handle()``) to share with
    the eval runner."""
    return EpochRunner(model, optimizer, constants, generator=generator, pool=pool,
                       stats=stats, step_fn=step_fn, **step_kw)


def make_eval_runner(model, constants: dict, *, pool=None, stats: list | None = None,
                     step_fn=None, **step_kw) -> EvalRunner:
    """JAX's ``make_eval_runner``: an :class:`EvalRunner` of ``step_fn``
    (:func:`eval_step`) with ``step_kw`` (its keywords)."""
    return EvalRunner(model, constants, pool=pool, stats=stats, step_fn=step_fn, **step_kw)
