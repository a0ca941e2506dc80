"""The trainer: epoch loop with validation, best-val checkpoints, true
resume, NaN abort and the final per-horizon test report, for every model
family of ``models.get_family`` (``model_name``), on the dense path and,
for DSTAGNN, on the block-sparse (BELL) and edge-list (ELL) paths.

Counterpart of ``dstagnn_drought_tpu/training/loop.py``. The batch plan and
the per-epoch shuffle seed ``seed*100003 + epoch`` are the JAX package's, so
both trainers see the same batches; padded tail rows get zero loss weight.
Each split is moved to the device once and a batch is gathered there by an
index vector. With ``sparse`` the graph of ``adj_merge`` is built before
the model: with ``sparse_format=bell`` the BlockEllGraph
(``mask_format=tiles`` puts the masks on its active-tile support) and, with
``rcm``, graphs and data splits are permuted by reverse Cuthill–McKee
(``evaluate`` returns predictions in the original node order); with
``sparse_format=ell`` (the default) the EllGraph, its slots capped at
``max_degree`` when that is set, and ``rcm`` leaves the node order alone,
as in JAX. ``fuse_tat``/``fuse_spatial`` take the steps
through the fused kernels; ``fuse_gtu`` (``"auto"`` resolves off, as in JAX)
takes the GTU tail through the fused GTU kernels and raises ``ValueError``
on shapes JAX's gate rejects (:func:`resolve_fuse_gtu`); the fused TAt and
GTU kernels take every shape JAX takes; on the card a ``fuse_tat``,
``fuse_spatial`` or BELL block past CUDA's grid or int32 limits (the
kernels take every width JAX's do) raises ``ValueError`` when the Trainer
is built (:func:`check_fused_shapes`).
``sparse``, ``fuse_tat`` and ``fuse_spatial`` on another family raise
JAX's ``ValueError`` before any data or graph is read (:func:`check_family`);
``use_pallas`` is accepted there and changes nothing, as in JAX.
A single-rank run outside debug mode trains and evaluates through the
whole-epoch runners (JAX's ``make_epoch_runner``/``make_eval_runner``,
:mod:`~dstagnn_drought_tpu_torch.training.step`): on the card every epoch
and every evaluation replays CUDA graphs (their records in
``graph_stats``), captured again after anything that replaces the state
they hold (:meth:`Trainer.invalidate_graphs`); on the CPU the runners run
the same steps eagerly. :meth:`Trainer.train_epoch_eager` and
:meth:`Trainer.evaluate_eager` are the step-by-step loop: debug mode and
mesh runs take it (gloo's collectives cannot be captured).
``debug`` runs each batch through the checked step (NaN/inf and batch
indices, :func:`~dstagnn_drought_tpu_torch.training.step.make_checked_train_step`);
``nan_policy = rollback`` restores the latest checkpoint, halves the
learning rate and retries the epoch (:meth:`Trainer._rollback_to_last_good`);
``tensorboard`` adds TensorBoard scalars under ``<run_dir>/tb``; ``remat``
recomputes DSTAGNN's block activations in the backward;
:meth:`Trainer.attention_maps` exports the per-block spatial maps.

On a mesh (``data_axis``/``graph_axis`` > 1, or a ``mesh`` from
:func:`~dstagnn_drought_tpu_torch.parallel.mesh.make_mesh`; one process a
rank) every rank builds the same batch plan and takes its data rank's rows
of each batch (``batch_size`` must divide over ``data_axis``); gradients
are summed over the data group so the update is the single-device one;
eval predictions are gathered in the data group before the padded tail is
cut. Over 'graph' the spatial conv is partitioned where JAX partitions it:
tile-resident BELL with the targeted block halo (``halo_overlap``: the
overlapped sublists), dense-mask BELL with the all-gather plan, ELL with
``halo = "targeted"``. There and on DSTAGNN's dense path the node axis is
sharded over 'graph' from the batch to the loss, as JAX shards it whenever
``graph_axis > 1``
(:class:`~dstagnn_drought_tpu_torch.parallel.sharding.NodeRows`; on the
dense path N padded to a multiple of the axis): each rank holds its node
rows of the splits and of every activation; what needs the whole node axis
(EmbedT, the TAt and the pre-conv; the dense spatial middle) runs whole
inside node-row regions that keep only their inputs' rows and run again
in the backward; the losses are summed over 'graph' and the predictions
gathered there. ELL without the targeted halo keeps its activations whole
and the same on every rank of a data row. Under ``tp`` the TAt
weights are sliced over 'graph'
(:mod:`~dstagnn_drought_tpu_torch.parallel.sharding`), and the per-device
parameter bytes (``tp_report``) are logged once as the ``tp`` event. The dropout
generator is seeded from the data coordinate only, so the ranks of a data
row draw the same bits. Only rank 0 writes files; a checkpoint holds whole
tensors gathered from the slices (``mask_tiles`` as (P, A_loc, K, BS, BS),
the TAt weights whole, the Adam moments alike, every data rank's generator),
and resume takes each rank's slices back.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dstagnn_drought_tpu_torch.config import Config
from dstagnn_drought_tpu_torch.data.adjacency import (
    edge_list_adjacency,
    load_dense_adjacency,
    load_stag_adjacency,
    load_strg_adjacency,
)
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, load_windowed_dataset
from dstagnn_drought_tpu_torch.device import compute_dtype, resolve_device
from dstagnn_drought_tpu_torch.models import get_family
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec
from dstagnn_drought_tpu_torch.ops.block_sparse import (
    block_ell_from_adjacency,
    rcm_permutation,
)
from dstagnn_drought_tpu_torch.ops.cuda import (
    bell_fused,
    block_spatial_fused,
    gtu_fused,
    tat_fused,
)
from dstagnn_drought_tpu_torch.ops.graph import cheb_polynomials, scaled_laplacian
from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency
from dstagnn_drought_tpu_torch.parallel import comm
from dstagnn_drought_tpu_torch.parallel.bell_partition import (
    build_bell_shard_plan,
    build_bell_tile_shard_plan,
    build_overlap_lists,
)
from dstagnn_drought_tpu_torch.parallel.graph_partition import build_halo_plan, shard_ell
from dstagnn_drought_tpu_torch.parallel.mesh import make_mesh, rank_device
from dstagnn_drought_tpu_torch.parallel.sharding import (
    NodeRows,
    ParamLayout,
    TensorParallel,
    batch_sharding,
    tat_tp_shardings,
    tp_report,
)
from dstagnn_drought_tpu_torch.training import checkpoint as ckpt
from dstagnn_drought_tpu_torch.training.logger import MetricLogger
from dstagnn_drought_tpu_torch.training.metrics import horizon_report
from dstagnn_drought_tpu_torch.training.step import (
    eval_step,
    make_checked_train_step,
    make_epoch_runner,
    make_eval_runner,
    make_optimizer,
    train_step,
)

PEMS_DATASETS = ("PEMS04", "PEMS08", "PEMS07", "PEMS03")


def check_parallel(cfg: Config) -> None:
    """The multi-device options' checks that need no process group, made
    before any data is read: positive axis sizes, and a ``batch_size`` that
    divides over ``data_axis`` (each data rank takes an equal share of every
    batch). A mesh that does not match the world raises in
    :func:`~dstagnn_drought_tpu_torch.parallel.mesh.make_mesh`."""
    t = cfg.training
    if t.data_axis < 1 or t.graph_axis < 1:
        raise ValueError(f"data_axis and graph_axis must be >= 1, got {t.data_axis}, "
                         f"{t.graph_axis}")
    if t.batch_size % t.data_axis:
        raise ValueError(f"batch_size={t.batch_size} must divide over "
                         f"data_axis={t.data_axis}")


def check_family(cfg: Config):
    """The family module of ``model_name``; for a family other than DSTAGNN,
    JAX's ``ValueError`` where ``sparse``, ``fuse_tat`` or ``fuse_spatial``
    asks for a DSTAGNN-only path, and a ``ValueError`` for ``remat`` (only
    DSTAGNN's forward takes it, as in JAX)."""
    t = cfg.training
    family = get_family(t.model_name or "dstagnn")
    if (t.model_name or "dstagnn").lower() != "dstagnn":
        if t.sparse:
            raise ValueError(
                f"sparse mode is a dstagnn-family path; got model_name={t.model_name!r}")
        if t.fuse_tat or t.fuse_spatial:
            raise ValueError(
                "fuse_tat/fuse_spatial are dstagnn-family kernels; got "
                f"model_name={t.model_name!r}")
        if t.remat:
            raise ValueError(
                f"remat is a dstagnn-family option; got model_name={t.model_name!r}")
    return family


def resolve_fuse_gtu(cfg: Config) -> bool:
    """The ``fuse_gtu`` knob as the JAX trainer resolves it: ``"auto"`` is
    off; ``True`` needs the dstagnn family and a shape the fused GTU kernels
    take (:func:`~dstagnn_drought_tpu_torch.ops.cuda.gtu_fused.supported`,
    JAX's gate; the kernels tile C and T, so it holds on the card in both
    compute dtypes), else ``ValueError``."""
    t = cfg.training
    if t.fuse_gtu == "auto" or not t.fuse_gtu:
        return False
    if t.model_name not in (None, "", "dstagnn"):
        raise ValueError(f"fuse_gtu is a dstagnn-family kernel; got model_name={t.model_name!r}")
    C, T = t.nb_time_filter, cfg.data.len_input
    if not gtu_fused.supported(C, T, t.time_strides):
        raise ValueError(
            "fuse_gtu=true but the fused GTU kernel does not support "
            f"nb_time_filter={C}, len_input={T}, "
            f"time_strides={t.time_strides} (needs stride 1, T >= 48 and 16 | T, "
            "16 | C) — unset fuse_gtu or use the default im2col path")
    return True


def check_fused_shapes(cfg: Config, device: torch.device, dtype: torch.dtype) -> None:
    """On a CUDA ``device``, ``ValueError`` naming the knob where a block's
    shape is one the kernels its knobs launch cannot take in the compute
    ``dtype``, so a config fails before its data is read, not at its first
    step: the fused TAt of ``fuse_tat``
    (:func:`~dstagnn_drought_tpu_torch.ops.cuda.tat_fused.limit_error`,
    both directions, the model's call without the embedding, as JAX's
    model makes it), the fused spatial middle of ``fuse_spatial`` on the
    dense path, where the model runs it
    (:func:`~dstagnn_drought_tpu_torch.ops.cuda.block_spatial_fused.limit_error`),
    and the BELL kernels (forward, K1, K2) on the BELL kernel path
    (``sparse_format = bell`` with ``use_pallas`` or ``mask_format =
    tiles``; :func:`~dstagnn_drought_tpu_torch.ops.cuda.bell_fused.limit_error`).
    Each is the shape function the kernel's wrapper raises at launch, at the
    block's batch, so this admits a config exactly when every launch admits
    its blocks; all three take every width JAX's kernels take and refuse
    only CUDA's grid limits and an int32 index guard. The CPU (the plain
    versions) takes every shape."""
    t = cfg.training
    bell_kernel = (t.sparse and t.sparse_format == "bell"
                   and (t.use_pallas or t.mask_format == "tiles"))
    spatial = t.fuse_spatial and not t.sparse
    if torch.device(device).type != "cuda" or not (t.fuse_tat or spatial or bell_kernel):
        return
    N, T, B = cfg.data.num_of_vertices, cfg.data.len_input, t.batch_size
    spec = ModelSpec.from_config(cfg)
    for i, (F, C) in enumerate(spec.block_specs):
        T_i = T if i == 0 else T // spec.time_strides
        why = []
        if t.fuse_tat:
            why += [("fuse_tat=true", "unset fuse_tat",
                     tat_fused.limit_error(T_i, N, spec.n_heads, spec.d_k, spec.d_v, dtype,
                                           backward, embed=False, BF=B * F))
                    for backward in (False, True)]
        if spatial:
            why.append(("fuse_spatial=true", "unset fuse_spatial",
                        block_spatial_fused.limit_error(
                            N, F * T_i, C, T_i, spec.nb_chev_filter, spec.d_model, spec.K,
                            spec.d_k, dtype, B)))
        if bell_kernel:
            why.append(("sparse_format=bell", "use the plain BELL path",
                        bell_fused.limit_error(t.batch_size, spec.K, C, spec.nb_chev_filter,
                                               dtype)))
        for knob, remedy, msg in why:
            if msg is not None:
                raise ValueError(f"{knob} but on the card block {i + 1}: {msg} — {remedy}")


def load_graphs(cfg: Config):
    """Adjacency loading policy of the reference: (adj_merge, adj_pa)."""
    d = cfg.data
    if d.dataset_name in PEMS_DATASETS:
        adj_mx = edge_list_adjacency(d.adj_filename, d.num_of_vertices, d.id_filename)
    else:
        adj_mx = load_dense_adjacency(d.adj_filename, d.num_of_vertices)
    adj_tmd = load_stag_adjacency(d.stag_filename, d.num_of_vertices)
    adj_pa = load_strg_adjacency(d.strg_filename)
    adj_merge = adj_mx if cfg.training.graph == "G" else adj_tmd
    return np.asarray(adj_merge, np.float32), np.asarray(adj_pa, np.float32)


class Trainer:
    def __init__(
        self,
        cfg: Config,
        dataset: Optional[ArrayDataset] = None,
        adj_merge: Optional[np.ndarray] = None,
        adj_pa: Optional[np.ndarray] = None,
        experiments_root: str = "myexperiments",
        device: str | torch.device | None = None,
        mesh=None,
    ):
        self.device = resolve_device(rank_device(device))
        self.compute_dtype = compute_dtype(cfg.training.compute_dtype)
        self.family = check_family(cfg)
        self.fuse_gtu = resolve_fuse_gtu(cfg)
        check_fused_shapes(cfg, self.device, self.compute_dtype)
        check_parallel(cfg)
        self.cfg = cfg
        t = cfg.training
        self.spec = ModelSpec.from_config(cfg)
        if mesh is None and (t.data_axis > 1 or t.graph_axis > 1):
            mesh = make_mesh(t.data_axis, t.graph_axis)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.writer = not dist.is_initialized() or dist.get_rank() == 0

        if dataset is None:
            dataset = load_windowed_dataset(
                cfg.data.graph_signal_matrix_filename,
                t.num_of_hours, t.num_of_days, t.num_of_weeks,
            )
        self.dataset = dataset
        if adj_merge is None or adj_pa is None:
            adj_merge, adj_pa = load_graphs(cfg)

        # RCM reordering for the block-sparse path only, as in JAX:
        # node-indexed state lives in the permuted order; evaluate() maps
        # predictions back
        self._perm = self._inv_perm = None
        bell = ell = None
        if t.sparse and t.sparse_format == "bell":
            if t.rcm:
                adj_merge = np.asarray(adj_merge)
                perm = rcm_permutation(np.maximum(adj_merge, adj_merge.T))
                self._perm, self._inv_perm = perm, np.argsort(perm)
                adj_merge = adj_merge[np.ix_(perm, perm)]
                adj_pa = np.asarray(adj_pa)[np.ix_(perm, perm)]
            # built before the model: tile-resident masks live on its support
            bell = block_ell_from_adjacency(adj_merge, block_size=t.block_size)
        elif t.sparse:
            ell = ell_from_adjacency(adj_merge, max_degree=t.max_degree or None)

        self.model, self.constants = self.family.make_model(
            self.spec, adj_merge, adj_pa, seed=t.seed, device=self.device,
            **({"bell": bell} if t.mask_format == "tiles" else {}))
        model_kw = self._partition(adj_merge, adj_pa, bell, ell)
        if bell is not None:
            self.constants["bell"] = bell.to(self.device)
        if ell is not None:
            self.constants["ell"] = self.constants.get("ell", ell).to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), t.learning_rate, self.device)
        # the ranks of a data row draw the same dropout bits
        d = self.mesh.d if self.mesh is not None else 0
        self.generator = torch.Generator(device=self.device).manual_seed(t.seed + 1000003 * d)
        self._model_kw = model_kw
        self._data_group = self.mesh.data_group if self.mesh is not None else None
        self._step_kw = dict(compute_dtype=self.compute_dtype, use_pallas=t.use_pallas,
                             fuse_tat=t.fuse_tat, fuse_spatial=t.fuse_spatial,
                             fuse_gtu=self.fuse_gtu, remat=t.remat,
                             data_group=self._data_group,
                             **({"model_kw": model_kw} if model_kw else {}))
        self.checked_step = make_checked_train_step(**self._step_kw) if t.debug else None
        self._lr_scale = 1.0
        self._rollbacks = 0
        # the whole-epoch runners (single rank, not debug; CUDA graphs on the
        # card), made at first use and again after invalidate_graphs(); one
        # record a CUDA graph
        self.use_runners = self.mesh is None and not t.debug
        self.graph_stats: list[dict] = []
        self._runners = None

        self.run_dir = ckpt.run_dir(
            experiments_root, cfg.data.dataset_name, t.model_name,
            t.num_of_hours, t.num_of_days, t.num_of_weeks,
            t.in_channels, t.learning_rate,
        )
        # only rank 0 writes files (and prints the metric lines)
        self.logger = MetricLogger(
            os.path.join(self.run_dir, "metrics.jsonl"),
            tensorboard_dir=os.path.join(self.run_dir, "tb") if t.tensorboard else None,
        ) if self.writer else MetricLogger(None, echo=False)
        if self.tp_report is not None:
            self.logger.log("tp", **self.tp_report)  # per-device parameter bytes
        self.best_val = math.inf
        self.best_epoch = -1
        self.epoch = t.start_epoch
        self.last_epoch_steps = 0
        self.last_losses: list[float] = []

        # device-resident splits (on node rows, this rank's rows); a batch
        # is a gather by an index vector
        self._splits = {}
        for name in ("train", "val", "test"):
            x, y = getattr(dataset, name).x, getattr(dataset, name).target
            if self._perm is not None:
                x, y = x[:, self._perm], y[:, self._perm]
            x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y))
            if self.rows is not None:
                x, y = self.rows.cut(x, 1), self.rows.cut(y, 1)
            self._splits[name] = (x.to(self.device), y.to(self.device))

    # ------------------------------------------------------------------
    def _partition(self, adj_merge, adj_pa, bell, ell) -> dict:
        """JAX's multi-device wiring on this rank's mesh: the plans of the
        partitioned spatial conv, the node rows that it or DSTAGNN's dense
        path shards (``self.rows``) and the TAt placement under ``tp``; the model's sliced parameters
        (``self.layout``) are replaced by this rank's slices. Returns the
        forward's ``halo``/``rows``/``tp`` keywords."""
        t, mesh = self.cfg.training, self.mesh
        self.layout = self.tp_report = self.rows = None
        if mesh is None:
            return {}
        kw, tp_axes, plan = {}, {}, None
        if t.tp and mesh.graph > 1:
            named = dict(self.model.named_parameters())
            tp_axes = tat_tp_shardings(named, mesh)
            self.tp_report = tp_report(named, mesh)
            if tp_axes:
                kw["tp"] = TensorParallel(mesh, tp_axes, self.spec.n_heads)
        if t.sparse and mesh.graph > 1 and t.sparse_format == "bell":
            if t.mask_format == "tiles":
                # tile-resident: targeted block halo, masks sliced over 'graph'
                polys = cheb_polynomials(
                    scaled_laplacian(torch.as_tensor(np.asarray(adj_merge), dtype=torch.float32)),
                    t.K).numpy()
                plan = build_bell_tile_shard_plan(bell, mesh.graph, np.asarray(adj_pa), polys)
                kw["halo"] = ((mesh, plan, build_overlap_lists(plan)) if t.halo_overlap
                              else (mesh, plan))
                self.constants.pop("bell_tiles", None)
            else:
                # dense masks: one all-gather of the source rows
                kw["halo"] = (mesh, build_bell_shard_plan(bell, mesh.graph))
            n_pad = kw["halo"][1].padded_nodes
        elif (t.sparse and t.halo == "targeted" and mesh.graph > 1
              and t.sparse_format == "ell"):
            # targeted boundary-row halo; N padded to a multiple of the axis
            ell = shard_ell(ell, mesh.graph)
            self.constants["ell"] = ell
            kw["halo"] = (mesh, build_halo_plan(ell, mesh.graph))
            n_pad = ell.num_nodes
        dense = (not t.sparse and mesh.graph > 1
                 and (t.model_name or "dstagnn").lower() == "dstagnn")
        if dense:
            # N padded to a multiple of the axis; with fuse_spatial EmbedS
            # runs whole, inside the spatial middle's region
            n_pad = -(-self.spec.num_of_vertices // mesh.graph) * mesh.graph
        if "halo" in kw or dense:
            # the node axis sharded over 'graph' from the batch to the loss
            self.rows = kw["rows"] = NodeRows(
                mesh, self.spec.num_of_vertices, n_pad,
                whole=("EmbedS",) if dense and t.fuse_spatial else ())
        self.layout = ParamLayout(mesh, tp_axes, tiles=plan is not None)
        whole = {k: v.detach() for k, v in self.model.state_dict().items()}
        for k, v in whole.items():
            if plan is not None and k.endswith("cheb_conv_SAt.mask_tiles"):
                # the single-device init's tiles in the (P, A_loc, ...) layout
                whole[k] = torch.from_numpy(plan.pack_active(v.cpu().numpy())).to(v.device)
        self.layout.shard_(self.model, whole)
        return kw

    def _param_names(self) -> list:
        return [n for n, _ in self.model.named_parameters()]

    def _barrier(self) -> None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            comm.all_reduce(torch.zeros(1, device=self.device), dist.group.WORLD)

    def _save(self, epoch: int, metadata: dict) -> None:
        """Whole tensors gathered from every rank's slices (collective);
        rank 0 writes."""
        model_state = self.model_state()
        optimizer_state = self.optimizer.state_dict()
        generators = None
        if self.layout is not None:
            optimizer_state = self.layout.whole_optimizer(optimizer_state, self._param_names())
            if self._data_group is not None:
                state = self.generator.get_state().to(self.device)
                generators = comm.all_gather(state[None], 0, self._data_group).cpu()
        if self.writer:
            ckpt.save_checkpoint(
                self.run_dir, epoch,
                model_state=model_state,
                optimizer_state=optimizer_state,
                generator_state=self.generator.get_state(),
                metadata=metadata,
                generators=generators,
            )
        self._barrier()  # the file exists before any rank reads it

    def _load(self, state: dict, optimizer: bool = True) -> None:
        """A checkpoint's whole tensors into this rank's model (its
        slices), and with ``optimizer`` the Adam state and this data rank's
        generator."""
        model_state = state["model"]
        if self.layout is not None:
            model_state = self.layout.local_state(model_state)
        self.model.load_state_dict(model_state)
        if not optimizer:
            return
        if state["optimizer"] is not None:
            opt = state["optimizer"]
            if self.layout is not None:
                opt = self.layout.local_optimizer(opt, self._param_names())
            # this optimizer's capturable (the card's Adam), wherever it was saved
            capturable = self.optimizer.defaults["capturable"]
            opt = dict(opt, param_groups=[dict(g, capturable=capturable)
                                          for g in opt["param_groups"]])
            self.optimizer.load_state_dict(opt)
        self.invalidate_graphs()
        generators = state.get("generators")
        if generators is not None and self.mesh is not None:
            self.generator.set_state(generators[self.mesh.d].cpu())
        elif state["generator"] is not None:
            self.generator.set_state(state["generator"].cpu())

    def load_model_state(self, state: dict) -> None:
        """Whole weights (a checkpoint's, or a single-device model's in the
        mesh's layout, e.g. from ``params_from_jax``) into this rank's model."""
        self._load({"model": state}, optimizer=False)

    def model_state(self) -> dict:
        """The whole weights, gathered from every rank's slices
        (collective on a mesh)."""
        state = self.model.state_dict()
        return state if self.layout is None else self.layout.whole_state(state)

    def resume(self) -> bool:
        """True resume from the latest checkpoint in the run dir."""
        latest = ckpt.latest_checkpoint(self.run_dir)
        if latest is None:
            return False
        state = ckpt.restore_checkpoint(latest, map_location=self.device)
        self._load(state)
        meta = state["meta"]
        self.epoch = int(meta.get("epoch", -1)) + 1
        self.best_val = float(meta.get("best_val", math.inf))
        self.best_epoch = int(meta.get("best_epoch", -1))
        self.logger.log("resume", epoch=self.epoch, checkpoint=latest)
        return True

    # ------------------------------------------------------------------
    def invalidate_graphs(self) -> None:
        """Capture the CUDA graphs again at their next use: after anything
        that replaces a tensor they hold (Adam's state, the generator's
        state) or a number baked into them (the lr). Loading weights into
        the parameters (``_load(optimizer=False)``) copies in place and
        keeps them."""
        self._runners = None

    def runners(self):
        """(epoch runner, eval runner) of this single-rank run, sharing one
        CUDA graph memory pool on the card; made here at first use, and
        again where the compute dtype, the optimizer, the generator or a
        constant was replaced since (their graphs hold the old ones)."""
        t = self.cfg.training
        key = (self.compute_dtype, id(self.optimizer), id(self.generator),
               [(k, id(v)) for k, v in self.constants.items()])
        if self._runners is None or self._runners[2] != key:
            pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
            self._runners = (
                make_epoch_runner(self.model, self.optimizer, self.constants,
                                  generator=self.generator, pool=pool, stats=self.graph_stats,
                                  step_fn=train_step, **self._step_kw),
                make_eval_runner(self.model, self.constants, pool=pool, stats=self.graph_stats,
                                 step_fn=eval_step, compute_dtype=self.compute_dtype,
                                 use_pallas=t.use_pallas, fuse_tat=t.fuse_tat,
                                 fuse_spatial=t.fuse_spatial, fuse_gtu=self.fuse_gtu,
                                 model_kw=self._model_kw),
                key)
        return self._runners[:2]

    def _train_plan(self, epoch: int):
        """The epoch's (nb, B) batch plan (numpy) and its loss weights on the
        device: zero on the padded tail."""
        t = self.cfg.training
        idx, n_valid = self.dataset.batch_indices(
            "train", t.batch_size, shuffle=True, seed=t.seed * 100003 + epoch
        )
        weights = (np.arange(idx.size) < n_valid).astype(np.float32).reshape(idx.shape)
        return idx, torch.from_numpy(weights).to(self.device)

    def train_epoch(self, epoch: int) -> float:
        """One training epoch, its mean loss: through the epoch runner (CUDA
        graphs on the card) on a single rank outside debug mode, else
        :meth:`train_epoch_eager`."""
        if not self.use_runners:
            return self.train_epoch_eager(epoch)
        idx, weights = self._train_plan(epoch)
        x_full, y_full = self._splits["train"]
        idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        losses = self.runners()[0](x_full, y_full, idx, weights, weights.sum(dim=1))
        return self._epoch_loss(epoch, losses)

    def train_epoch_eager(self, epoch: int) -> float:
        """The epoch step by step from the host: debug mode and mesh runs,
        and the loop a graphed epoch is held to."""
        t = self.cfg.training
        x_full, y_full = self._splits["train"]
        idx, weights = self._train_plan(epoch)
        # this data rank's rows of every batch; the loss is divided by the
        # global batch's weight sum
        rows = batch_sharding(self.mesh, t.batch_size) if self.mesh is not None else slice(None)
        totals = weights.sum(dim=1)
        losses = []
        if self.checked_step is not None:
            # debug mode: one checked step a batch; a NaN/inf or an index
            # outside the split raises here, naming the op and the batch
            for b in range(idx.shape[0]):
                losses.append(self.checked_step(
                    self.model, self.optimizer, x_full, y_full, idx[b][rows], self.constants,
                    weights=weights[b, rows], generator=self.generator, batch=b,
                    weight_total=totals[b]))
        else:
            idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            for b in range(idx.shape[0]):
                ib = idx[b, rows]
                losses.append(train_step(
                    self.model, self.optimizer, x_full[ib], y_full[ib],
                    self.constants, weights=weights[b, rows], weight_total=totals[b],
                    generator=self.generator, **self._step_kw,
                ))
        return self._epoch_loss(epoch, torch.stack(losses))

    def _epoch_loss(self, epoch: int, losses: torch.Tensor) -> float:
        """The epoch's per-step losses (every graph and data rank's share
        summed) read once, kept in ``last_losses``; their mean. A NaN raises
        ``FloatingPointError`` outside debug mode."""
        self.last_epoch_steps = len(losses)
        if self.rows is not None:
            losses = comm.all_reduce(losses, self.rows.group)
        losses = comm.all_reduce(losses, self._data_group)
        self.last_losses = losses.tolist()  # the epoch's per-step losses
        mean_loss = float(losses.mean())
        if self.checked_step is not None:
            return mean_loss
        if math.isnan(mean_loss):
            raise FloatingPointError(
                f"NaN training loss at epoch {epoch} — aborting (last good "
                f"checkpoint: epoch_{self.best_epoch})"
            )
        return mean_loss

    def evaluate(self, split: str) -> tuple[np.ndarray, float]:
        """Predictions (true length, float32 numpy) and mean loss of a split:
        through the eval runner (a CUDA graph on the card) on a single rank
        outside debug mode, else :meth:`evaluate_eager`."""
        return self._evaluate(split, self.runners()[1] if self.use_runners else None)

    def evaluate_eager(self, split: str) -> tuple[np.ndarray, float]:
        """:meth:`evaluate` batch by batch from the host."""
        return self._evaluate(split, None)

    def _evaluate(self, split: str, runner) -> tuple[np.ndarray, float]:
        t = self.cfg.training
        x_full, y_full = self._splits[split]
        idx, n_valid = self.dataset.batch_indices(split, t.batch_size, shuffle=False)
        idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        if runner is not None:
            pred, per_sample = runner(x_full, y_full, idx)
        else:
            rows = (batch_sharding(self.mesh, t.batch_size) if self.mesh is not None
                    else slice(None))
            preds, losses = [], []
            for b in range(idx.shape[0]):
                ib = idx[b, rows]
                p, l = eval_step(
                    self.model, x_full[ib], y_full[ib], self.constants,
                    compute_dtype=self.compute_dtype, use_pallas=t.use_pallas,
                    fuse_tat=t.fuse_tat, fuse_spatial=t.fuse_spatial,
                    fuse_gtu=self.fuse_gtu, model_kw=self._model_kw,
                )
                preds.append(p)
                losses.append(l)
            pred, per_sample = torch.stack(preds), torch.stack(losses)
        if self.rows is not None:  # every graph rank's node rows and loss shares
            pred = self.rows.gather(pred, 2)
            per_sample = comm.all_reduce(per_sample, self.rows.group)
        # every data rank's rows, batch by batch, before the tail is cut
        pred = comm.all_gather(pred, 1, self._data_group)
        per_sample = comm.all_gather(per_sample, 1, self._data_group)
        pred = pred.reshape(-1, *pred.shape[2:]).cpu().numpy()[:n_valid]
        per_sample = per_sample.reshape(-1).cpu().numpy()[:n_valid]
        if self._inv_perm is not None:
            pred = pred[:, self._inv_perm]  # back to the original node order
        return pred, float(per_sample.mean())

    @torch.no_grad()
    def attention_maps(self, split: str = "test", sample: int = 24) -> list:
        """Per-block spatial maps of one sample, ``min(sample, n-1)``, of a
        split (the reference's legacy export takes batch 24): deterministic,
        float32, through the forward JAX's export calls (the graph and the
        BELL tiles, no ``use_pallas`` and no fused options). A list of
        per-block arrays: (K, N, N) dense, (K, N, E) ELL, block scores on
        BELL, scalar zeros on BELL tiles, whose kernel never materialises
        them. With ``rcm`` the maps are in the internal (RCM) node order:
        ``self._perm`` maps an internal index to the original node."""
        x_full, _ = self._splits[split]
        n = len(getattr(self.dataset, split))
        i = min(sample, n - 1)
        c = self.constants
        out = self.model(x_full[i:i + 1], adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                         deterministic=True, bell=c.get("bell"), bell_tiles=c.get("bell_tiles"),
                         ell=c.get("ell"), return_attention=True, **self._model_kw)
        return [(m[0] if m.ndim else m).float().cpu().numpy() for m in out[1]]

    def _rollback_to_last_good(self, epoch: int) -> None:
        """NaN recovery: restore the latest checkpoint's model, Adam state
        and generator, halve the learning rate, log ``rollback``; the caller
        retries the epoch. ``FloatingPointError`` where there is no
        checkpoint."""
        t = self.cfg.training
        latest = ckpt.latest_checkpoint(self.run_dir)
        if latest is None:
            raise FloatingPointError(
                f"NaN loss at epoch {epoch} and no checkpoint to roll back to")
        state = ckpt.restore_checkpoint(latest, map_location=self.device)
        self._load(state)
        self._rollbacks += 1
        self._lr_scale *= 0.5
        if state["optimizer"] is None:
            self.optimizer = make_optimizer(self.model.parameters(), t.learning_rate,
                                            self.device)
        # load_state_dict brings back the saved lr: the halved one goes in after it
        lr = t.learning_rate * self._lr_scale
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.invalidate_graphs()  # the graphs hold the old lr (and maybe optimizer)
        self.logger.log("rollback", epoch=epoch, checkpoint=latest, lr=lr,
                        rollbacks=self._rollbacks)

    # ------------------------------------------------------------------
    def run(self, epochs: Optional[int] = None) -> dict:
        t = self.cfg.training
        end_epoch = epochs if epochs is not None else t.epochs
        while self.epoch < end_epoch:
            e = self.epoch
            t0 = time.perf_counter()
            try:
                train_loss = self.train_epoch(e)  # reading the loss synchronizes
            except FloatingPointError:
                if t.nan_policy == "rollback" and self._rollbacks < t.max_rollbacks:
                    self._rollback_to_last_good(e)
                    continue
                raise
            train_seconds = time.perf_counter() - t0
            _, val_loss = self.evaluate("val")
            self.logger.log(
                "epoch", epoch=e, train_loss=train_loss, val_loss=val_loss,
                seconds=round(time.perf_counter() - t0, 2),
                train_seconds=train_seconds, steps=self.last_epoch_steps,
            )
            if val_loss < self.best_val:
                self.best_val = val_loss
                self.best_epoch = e
                self._save(e, {"best_val": self.best_val, "best_epoch": e,
                               "val_loss": val_loss})
            elif t.checkpoint_every and (e + 1) % t.checkpoint_every == 0:
                self._save(e, {"best_val": self.best_val,
                               "best_epoch": self.best_epoch})
            self.epoch += 1
        return self.final_test()

    def final_test(self) -> dict:
        # reload the best-val weights
        if self.best_epoch >= 0:
            best = ckpt.checkpoint_path(self.run_dir, self.best_epoch)
            if os.path.exists(best):
                state = ckpt.restore_checkpoint(best, map_location=self.device)
                self._load(state, optimizer=False)
        pred, test_loss = self.evaluate("test")
        report = horizon_report(self.dataset.test.target, pred, null_val=0)
        self.logger.log(
            "test", loss=test_loss, best_epoch=self.best_epoch,
            mae=report["overall"]["mae"], rmse=report["overall"]["rmse"],
            mape=report["overall"]["mape"],
        )
        if self.writer:
            np.savez(
                os.path.join(self.run_dir, f"output_epoch_{self.best_epoch}_test.npz"),
                input=self.dataset.test.x,
                prediction=pred, data_target_tensor=self.dataset.test.target,
            )
        return {"test_loss": test_loss, "report": report,
                "best_epoch": self.best_epoch, "best_val": self.best_val}
