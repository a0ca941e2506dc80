"""Multi-device training of the port on 2 and 4 gloo ranks against the JAX
trainer on the same mesh shape (its virtual CPU devices) and against the
port's single-rank run, from the same weights (JAX's initial parameters,
carried by ``params_from_jax``) and the same batches, dropout 0: 5-step
trajectories at (data, graph) = (2, 1), (1, 2) and (2, 2) on the dense, the
ELL targeted-halo and the BELL-tiles paths (with ``fuse_gtu`` too), and
(1, 2) with ``tp`` and with ``fuse_spatial`` and dropout. The parameters
every rank holds whole stay bit-identical across ranks, and the first
step's gradients equal the single-rank ones where a control without the
graph (or data) sum does not. At graph > 1 every block output, conv output
and prediction of a rank holds its Np/P node rows; the node-row regions
(EmbedT, the TAt and the pre-conv; the dense spatial middle) keep only the
rows of their inputs, and what autograd saves outside them and the
partitioned conv (whose halo brings other ranks' rows) is the single-rank
run's share of those rows; a region's forward gives the rows of the whole
computation bit for bit. Then a checkpoint saved by rank 0 and resumed at
(1, 2), a checkpoint read by JAX's ``import_torch_state_dict``, and the CLI
under two gloo ranks started through the environment ``torchrun`` sets.

One module-scoped spawn a world size serves the trajectories (the ranks
import this file, which imports JAX only inside the tests); the ranks train
while JAX's runs compile and train, four at a time. JAX's BELL-tiles side runs one tile list a shard where
the port runs the overlapped sublists: the same function."""
import functools
import hashlib
import json
import os
import socket
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dstagnn_drought_tpu_torch.cli import train as train_cli
from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig, load_config
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec, params_from_jax
from dstagnn_drought_tpu_torch.parallel.launch import spawn
from dstagnn_drought_tpu_torch.training.loop import Trainer

N, F, T, PRED, BS = 30, 1, 12, 6, 8  # 4 BELL tiles: no inert tile at graph 2
FUSE_T = 48  # the fused GTU's gate: T >= 48 and 16 | T (and 16 | C)
STEPS, LOSS_RTOL, WEIGHT_TOL = 5, 2e-3, 5e-3
GRAD_TOL = 5e-3  # the first step's gradients, of each tensor's own scale
BASE = dict(in_channels=F, nb_block=2, n_heads=2, K=2, d_k=8, d_model=16, nb_chev_filter=8,
            nb_time_filter=8, batch_size=4, epochs=STEPS, learning_rate=3e-3, dropout=0.0)
TILES = dict(sparse=True, sparse_format="bell", block_size=BS, mask_format="tiles")
RUNS = {  # name: (world size, [Training] keys)
    "dense_d2": (2, dict(data_axis=2)),
    "dense_g2": (2, dict(graph_axis=2)),
    "ell_g2": (2, dict(graph_axis=2, sparse=True, halo="targeted")),
    "tiles_g2": (2, dict(graph_axis=2, **TILES)),
    "dense_g2_tp": (2, dict(graph_axis=2, tp=True)),
    "dense_d2g2": (4, dict(data_axis=2, graph_axis=2)),
    "tiles_d2g2": (4, dict(data_axis=2, graph_axis=2, halo_overlap=False, **TILES)),
    # JAX's trainer takes these knobs on a mesh, and so does the port: tp
    # with the fused TAt (the slices gathered whole for the kernel, as GSPMD
    # gives a pallas_call whole operands), and the tile path with rcm, remat
    # and the debug mode's checked steps
    "dense_g2_tp_fused": (2, dict(graph_axis=2, tp=True, fuse_tat=True)),
    "tiles_g2_knobs": (2, dict(graph_axis=2, rcm=True, remat=True, debug=True, **TILES)),
    # the fused GTU on each rank's node rows (T = FUSE_T, C = 16)
    "tiles_g2_fuse_gtu": (2, dict(graph_axis=2, fuse_gtu=True, nb_chev_filter=16,
                                  nb_time_filter=16, **TILES)),
    # the TAt and the fused spatial middle in one region, its dropout
    # replayed in the backward's recompute
    "dense_g2_fuse_spatial": (2, dict(graph_axis=2, fuse_spatial=True, dropout=0.05)),
}
# JAX's BELL-tiles and fused trainers run their Pallas kernels in interpret
# mode, a minute a run here: the tiles train at (2, 2) on JAX's side, and
# these runs are held to the port's single-rank run (the partitioned conv
# to JAX's in test_torch_parallel_conv.py)
NO_JAX = ("tiles_g2", "dense_g2_tp_fused", "tiles_g2_knobs", "tiles_g2_fuse_gtu",
          "dense_g2_fuse_spatial")
# the runs whose node axis is sharded over 'graph'
ROWS = [name for name, (_, keys) in RUNS.items() if keys.get("graph_axis", 1) > 1]


def _len(keys) -> int:
    return FUSE_T if keys.get("fuse_gtu") else T


def _data(t=T):
    rng = np.random.default_rng(5)
    A = (rng.random((N, N)) < 0.2).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.5) & ((A + np.eye(N)) > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    x = rng.normal(size=(12, N, F, t)).astype(np.float32)
    y = np.repeat(x[:, :, -1, :].mean(axis=2, keepdims=True), PRED, axis=2).astype(np.float32)
    return A, pa, x, y


def _dataset(split_cls, dataset_cls, x, y):
    sp = lambda s: split_cls(x[s], y[s])
    return dataset_cls(train=sp(slice(0, 4)), val=sp(slice(4, 8)), test=sp(slice(8, 12)),
                       mean=np.zeros((1, 1, F, 1)), std=np.ones((1, 1, F, 1)))


def _config(config_cls, data_cls, training_cls, **keys):
    return config_cls(
        data=data_cls(num_of_vertices=N, len_input=_len(keys), num_for_predict=PRED,
                      dataset_name="PTOY"),
        training=training_cls(**{**BASE, **keys})).validate()


def _trainer(root, init=None, **keys) -> Trainer:
    A, pa, x, y = _data(_len(keys))
    tr = Trainer(_config(Config, DataConfig, TrainingConfig, **keys),
                 dataset=_dataset(Split, ArrayDataset, x, y), adj_merge=A, adj_pa=pa,
                 experiments_root=str(root), device="cpu")
    if init is not None:
        tr.load_model_state({k: torch.from_numpy(v) for k, v in init.items()})
    return tr


def _digests(tr) -> dict:
    return {n: hashlib.sha1(p.detach().numpy().tobytes()).hexdigest()
            for n, p in tr.model.named_parameters()
            if tr.layout is None or not tr.layout.sliced(n)}


# the spatial convs of models.dstagnn (the partitioned ones return node rows)
PARTITIONED = ("partitioned_bell_conv", "partitioned_bell_tiles_conv",
               "partitioned_bell_tiles_conv_overlap", "halo_partitioned_sparse_conv")
SINGLE_CONVS = ("bell_cheb_conv_tiles", "sparse_spatial_attention_scores",
                "sparse_cheb_conv_with_sat")


class _Probe:
    """Over the first epoch (one step): the node-axis length of every block
    output, partitioned conv output, node-row region output and prediction
    (``shapes``), the bytes autograd saves by part (``saved``: ``temporal``,
    EmbedT, the TAt and the pre-conv, ``STBlock.temporal`` and
    ``STBlock.pre_project``; ``conv``, the spatial conv, with the dense
    ``STBlock.dense_conv`` and ``STBlock.fused_middle``; ``region``, what a
    node-row region (``NodeRows.region``) keeps; ``rest``; a tensor saved
    twice counts twice, parameters do not count) and, in order, the bytes of
    each tensor saved there (``each``), the bytes of the tensors a region's
    computation (``STBlock.front``, ``dense_conv``, ``fused_middle``) is
    given (``inputs``), and the step's gradients as Adam takes them
    (``grads``) and, where the step sums them over a group, before the
    first sum (``own``, the control)."""

    def __init__(self, tr):
        from dstagnn_drought_tpu_torch.models import dstagnn
        from dstagnn_drought_tpu_torch.parallel import comm

        self.tr, self.dstagnn, self.comm = tr, dstagnn, comm
        self.shapes, self.saved, self.grads, self.own = [], dict.fromkeys(
            ("temporal", "conv", "region", "rest"), 0), {}, {}
        self.each = {k: [] for k in self.saved}
        self.inputs = []
        self.region = "rest"
        self.params = {p.untyped_storage().data_ptr() for p in tr.model.parameters()}

    def _in(self, region, fn, shape=None, inputs=False):
        def run(*a, **k):
            if inputs:  # the tensors after self
                self.inputs += [t.numel() * t.element_size() for t in a[1:]]
            outer = self.region
            self.region = region or outer
            try:
                out = fn(*a, **k)
            finally:
                self.region = outer
            if shape is not None:
                self.shapes.append((shape, out[0].shape[1] if shape == "region"
                                    else out.shape[1]))
            return out
        return run

    def _pack(self, t):
        if t.untyped_storage().data_ptr() not in self.params:
            n = t.numel() * t.element_size()
            self.saved[self.region] += n
            self.each[self.region].append(n)
        return t

    def _grads(self):
        return {n: p.grad.detach().clone() for n, p in self.tr.model.named_parameters()
                if p.grad is not None}

    def __enter__(self):
        from dstagnn_drought_tpu_torch.parallel.sharding import NodeRows

        d, model = self.dstagnn, self.tr.model
        methods = {"temporal": "temporal", "pre_project": "temporal", "front": None,
                   "dense_conv": "conv", "fused_middle": "conv"}
        self.undo = [(d.STBlock, n, getattr(d.STBlock, n)) for n in methods]
        self.undo += [(NodeRows, "region", NodeRows.region)]
        self.undo += [(self.comm, "reduce_gradients", self.comm.reduce_gradients)]
        self.undo += [(d, n, getattr(d, n)) for n in PARTITIONED + SINGLE_CONVS]
        for n, region in methods.items():
            fn = getattr(d.STBlock, n)
            setattr(d.STBlock, n, self._in(region, fn, inputs=region != "temporal"))
        NodeRows.region = self._in("region", NodeRows.region, "region")
        for n in PARTITIONED + SINGLE_CONVS:
            setattr(d, n, self._in("conv", getattr(d, n), "conv" if n in PARTITIONED else None))
        reduce = self.comm.reduce_gradients

        def reduce_first(params, group):
            if group is not None and not self.own:
                self.own.update(self._grads())
            return reduce(params, group)

        self.comm.reduce_gradients = reduce_first
        step = self.tr.optimizer.step

        def step_first(*a, **k):
            self.grads.update(self._grads())
            return step(*a, **k)

        self.tr.optimizer.step = step_first
        shape = lambda what: lambda m, a, out: self.shapes.append(
            (what, (out[0] if isinstance(out, tuple) else out).shape[1]))
        self.hooks = [b.register_forward_hook(shape("block")) for b in model.BlockList]
        self.hooks.append(model.register_forward_hook(shape("prediction")))
        self.saving = torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t)
        self.saving.__enter__()
        return self

    def __exit__(self, *exc):
        self.saving.__exit__(*exc)
        for h in self.hooks:
            h.remove()
        del self.tr.optimizer.step
        for owner, name, value in self.undo:
            setattr(owner, name, value)

    def record(self) -> dict:
        """The probe's findings, the gradients gathered whole (collective)."""
        tr = self.tr
        whole = (lambda g: g) if tr.layout is None else tr.layout.whole_state
        numpy = lambda d: {k: v.numpy() for k, v in whole(d).items()}
        rows = tr.rows
        return dict(shapes=self.shapes, saved=self.saved, each=self.each, inputs=self.inputs,
                    grads=numpy(self.grads),
                    own=numpy(self.own) if self.own else {},
                    nloc=None if rows is None else rows.nloc)


def _trajectory(root, init, keys):
    """(losses, whole final weights, digests of the parameters held whole,
    the first epoch's probe record)."""
    tr = _trainer(root, init, **keys)
    with _Probe(tr) as probe:
        losses = [tr.train_epoch(0)]
    losses += [tr.train_epoch(e) for e in range(1, STEPS)]
    return (losses, {k: v.numpy() for k, v in tr.model_state().items()}, _digests(tr),
            probe.record())


def _resume_and_checkpoint(root):
    """At (1, 2), BELL tiles with tp (both kinds of slices, the Adam moments
    with them): 2 epochs, a fresh trainer resumed from rank 0's checkpoint
    for epochs 2-3, against 4 epochs straight; then a dense tp run's
    checkpoint for JAX to read."""
    keys = dict(graph_axis=2, tp=True, checkpoint_every=1, **TILES)
    _trainer(root / "resumed", **keys).run(2)
    resumed = _trainer(root / "resumed", **keys)
    assert resumed.resume() and resumed.epoch == 2
    r = resumed.run(4)
    s = _trainer(root / "straight", **keys).run(4)
    dense = _trainer(root / "dense_tp", graph_axis=2, tp=True)
    dense.run(1)
    out = dict(resumed=r["test_loss"], straight=s["test_loss"], run_dirs=[
        str(resumed.run_dir), str(root / "straight" / os.path.relpath(
            resumed.run_dir, root / "resumed"))],
        dense_dir=str(dense.run_dir),
        dense_state={k: v.numpy() for k, v in dense.model_state().items()},
        mask_shape=tuple(resumed.model.BlockList[0].cheb_conv_SAt.mask_tiles.shape))
    return out


# the TAt placements of the region bits: (fuse_tat, tp)
REGION_CASES = {"plain": (False, False), "tp": (False, True), "tp_fused": (True, True)}


def _region_bits() -> dict:
    """On this rank of (1, 2), N padded to 32 (two pad rows on rank 1): each
    block's EmbedT, TAt and pre-conv (``STBlock.front``) inside a node-row
    region against the same function on the whole input outside it (the
    single run's arithmetic), for each of REGION_CASES ('tp': head-parallel
    slices; 'tp_fused': the slices gathered whole for the fused TAt, its
    plain version here). {case: {"rows", "scores", "grads"}}: the region's
    output rows, its whole scores, and the gradients of this rank's input
    rows and of every weight under a cotangent on this rank's rows, each
    equal bit for bit."""
    from dstagnn_drought_tpu_torch.models.dstagnn import make_model
    from dstagnn_drought_tpu_torch.parallel.mesh import make_mesh
    from dstagnn_drought_tpu_torch.parallel.sharding import (
        NodeRows,
        ParamLayout,
        TensorParallel,
        tat_tp_shardings,
    )

    A, pa, x, _ = _data()
    mesh = make_mesh(1, 2)
    rows = NodeRows(mesh, N, 32)
    spec = ModelSpec.from_config(_config(Config, DataConfig, TrainingConfig))
    g = torch.Generator().manual_seed(3)
    C = spec.nb_time_filter
    inputs = (torch.from_numpy(x[:4]), torch.randn(4, N, C, T, generator=g))
    cot = lambda shape: torch.randn(shape, generator=torch.Generator().manual_seed(4))
    out = {}
    for case, (fuse_tat, use_tp) in REGION_CASES.items():
        model, _ = make_model(spec, A, pa, seed=1, device="cpu")
        tp = None
        if use_tp:
            axes = tat_tp_shardings(dict(model.named_parameters()), mesh)
            ParamLayout(mesh, axes).shard_(model, dict(model.state_dict()))
            tp = TensorParallel(mesh, axes, spec.n_heads)
        res = torch.zeros(())
        same = dict(rows=True, scores=True, grads=True)
        for block, xin in zip(model.BlockList, inputs):
            front = functools.partial(block.front, fuse_tat=fuse_tat, tp=tp)
            x_rows = rows.cut(xin, 1).requires_grad_()
            got, got_s = rows.region(front, (x_rows, res), (1, None), (1, None))
            dy = cot(got.shape)  # this rank's rows of the whole cotangent
            dy = rows.zero_pads(dy, 1)
            got_g = torch.autograd.grad(got, [x_rows, *block.parameters()], dy,
                                        allow_unused=True)
            x_whole = xin.clone().requires_grad_()
            want, want_s = front(x_whole, res)
            dy_whole = rows.gather(dy, 1)
            want_g = torch.autograd.grad(want, [x_whole, *block.parameters()], dy_whole,
                                         allow_unused=True)
            want_g = (rows.cut(want_g[0], 1), *want_g[1:])
            same["rows"] &= torch.equal(got, rows.cut(want, 1))
            same["scores"] &= torch.equal(got_s, want_s)
            same["grads"] &= all((a is None and b is None) or torch.equal(a, b)
                                 for a, b in zip(got_g, want_g))
            res = want_s.detach()
        out[case] = same
    return out


def train_rank(rank, inits, root):
    """One gloo rank: every trajectory of its world size, then (world 2) the
    checkpoint cases and the region bits."""
    from pathlib import Path

    world = torch.distributed.get_world_size()
    out = {}
    for name, (size, keys) in RUNS.items():
        if size == world:
            out[name] = _trajectory(Path(root) / name, inits[name], keys)
    if world == 2:
        out["checkpoint"] = _resume_and_checkpoint(Path(root) / "ckpt")
        out["region_bits"] = _region_bits()
    return out


def _jax_trainer(name, keys, root):
    """The JAX trainer of a run on its mesh shape (JAX's virtual CPU
    devices), and its initial weights as a port state_dict."""
    import jax

    from dstagnn_drought_tpu.config import Config as JConfig
    from dstagnn_drought_tpu.config import DataConfig as JData
    from dstagnn_drought_tpu.config import TrainingConfig as JTraining
    from dstagnn_drought_tpu.data.dataset import ArrayDataset as JDataset
    from dstagnn_drought_tpu.data.dataset import Split as JSplit
    from dstagnn_drought_tpu.parallel.mesh import make_mesh

    from dstagnn_drought_tpu.training.loop import Trainer as JTrainer

    A, pa, x, y = _data(_len(keys))
    # the overlapped sublists compute the same function as one tile list;
    # JAX's side runs the one list, whose interpret-mode kernels cost half
    cfg = _config(JConfig, JData, JTraining, **dict(keys, halo_overlap=False))
    d, g = cfg.training.data_axis, cfg.training.graph_axis
    tr = JTrainer(cfg, dataset=_dataset(JSplit, JDataset, x, y), adj_merge=A, adj_pa=pa,
                  mesh=make_mesh(d, g, devices=jax.devices()[:d * g]),
                  experiments_root=str(root / name))
    return tr, _as_port(tr.params, keys)


def _as_port(params, keys):
    spec = ModelSpec.from_config(_config(Config, DataConfig, TrainingConfig, **keys))
    return {k: v.numpy() for k, v in params_from_jax(params, spec).items()}


def _unpartitioned(state, keys):
    """A state_dict with (P, A_loc, K, BS, BS) masks as the single-rank
    model's (A, K, BS, BS): each rank's true entries in order, the pad
    tiles' entries (the augmented list's tail) cut."""
    if keys.get("mask_format") != "tiles":
        return state
    from dstagnn_drought_tpu_torch.ops.block_sparse import (
        block_ell_from_adjacency,
        rcm_permutation,
    )
    from dstagnn_drought_tpu_torch.parallel.bell_partition import build_bell_tile_shard_plan

    A, pa, _, _ = _data()
    if keys.get("rcm"):  # the Trainer's node order
        perm = rcm_permutation(np.maximum(A, A.T))
        A, pa = A[np.ix_(perm, perm)], pa[np.ix_(perm, perm)]
    bell = block_ell_from_adjacency(A, block_size=BS)
    plan = build_bell_tile_shard_plan(bell, keys["graph_axis"], pa, np.zeros((2, N, N)))
    out = dict(state)
    for k, v in state.items():
        if k.endswith("cheb_conv_SAt.mask_tiles"):
            out[k] = np.concatenate([v[r, :n] for r, n in enumerate(plan.a_true)])[
                :bell.num_active]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX (init, losses, final), port single-rank (losses, final),
    every rank's (losses, final, digests))}, and the checkpoint record."""
    root = tmp_path_factory.mktemp("parallel_training")
    trainers = {name: _jax_trainer(name, keys, root / "jax") for name, (_, keys) in RUNS.items()}
    inits = {name: init for name, (_, init) in trainers.items()}  # JAX's initial weights
    ranks = {}

    def port_ranks():  # the ranks train while JAX compiles and trains here
        for w in (2, 4):
            ranks[w] = spawn(train_rank, w, inits, str(root / f"ranks{w}"), timeout=300,
                             init_dir=str(tmp_path_factory.mktemp("init")))

    thread = threading.Thread(target=port_ranks)
    thread.start()
    try:
        def jax_run(name):  # JAX releases the GIL while it compiles and runs
            tr, init = trainers[name]
            losses = [tr.train_epoch(e) for e in range(STEPS)]
            return name, (init, losses, _as_port(tr.params, RUNS[name][1]))

        with ThreadPoolExecutor(4) as pool:  # the tile runs, the slowest, first
            jax_side = dict(pool.map(jax_run, sorted(
                (n for n in RUNS if n not in NO_JAX), key=lambda n: "tiles" not in n)))
        single = {name: _trajectory(root / "single" / name, _unpartitioned(inits[name], keys),
                                    {k: v for k, v in keys.items()
                                     if k not in ("data_axis", "graph_axis", "tp")})
                  for name, (_, keys) in RUNS.items()}
    finally:
        thread.join()
    assert set(ranks) == {2, 4}, "a spawn failed (its error is above)"
    out = {name: (jax_side.get(name), single[name], [r[name] for r in ranks[w]])
           for name, (w, _) in RUNS.items()}
    return out, ranks[2][0]["checkpoint"], root / "jax", [r["region_bits"] for r in ranks[2]]


def _weights_close(got, want, what):
    for k, v in want.items():
        err = float(np.abs(got[k] - v).max())
        assert err <= WEIGHT_TOL * max(1.0, float(np.abs(v).max())), f"{what} {k}: {err}"


@pytest.mark.parametrize("name", list(RUNS))
def test_trajectory_matches_jax_and_single_rank(runs, name):
    jax_run, (s_losses, s_final, _, _), ranks = runs[0][name]
    losses, final, digests, _ = ranks[0]
    assert abs(losses[0] - losses[-1]) > 1e-4  # the trajectory moves
    np.testing.assert_allclose(losses, s_losses, rtol=LOSS_RTOL)
    if name not in NO_JAX:
        _, j_losses, j_final = jax_run
        np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
        _weights_close(final, j_final, "vs jax")
    if "tiles" in name:  # the single-rank model holds the tiles unpartitioned
        final = {k: v for k, v in final.items() if not k.endswith("mask_tiles")}
    _weights_close(final, {k: v for k, v in s_final.items() if k in final}, "vs single rank")
    for r, (_, _, other, _) in enumerate(ranks[1:], 1):  # replicated: bit-identical
        assert other == digests, f"rank {r} holds other bits"


def _grad_err(got, want) -> tuple[float, str]:
    """The largest max |Δ| over max |want| of one tensor, and its name."""
    worst = (0.0, "")
    for k, v in want.items():
        err, scale = float(np.abs(got[k] - v).max()), float(np.abs(v).max())
        worst = max(worst, (err / scale if scale else (0.0 if err == 0 else np.inf), k))
    return worst


@pytest.mark.parametrize("name", list(RUNS))
def test_first_step_gradients_and_the_unsummed_control(runs, name):
    """Every rank's first-step gradients, gathered whole, equal the
    single-rank run's, each tensor at its own scale; where the step sums
    gradients over a group (the node-row parameters over 'graph', every
    parameter over 'data'), the gradients before the first sum (the
    control: no graph sum at (1, 2)) miss that gate."""
    _, (_, _, _, single), ranks = runs[0][name]
    keys = RUNS[name][1]
    for rank in ranks:
        probe = rank[3]
        err, worst = _grad_err(_unpartitioned(probe["grads"], keys), single["grads"])
        assert err <= GRAD_TOL, f"{worst}: {err} of its scale"
    own = ranks[0][3]["own"]
    assert bool(own) == (name in ROWS or keys.get("data_axis", 1) > 1)
    if own:
        control, worst = _grad_err(_unpartitioned(own, keys), single["grads"])
        assert control > GRAD_TOL, f"the control passes: {worst} {control}"


@pytest.mark.parametrize("name", ROWS)
def test_partitioned_runs_hold_node_rows(runs, name):
    """At graph > 1 every block output, partitioned conv output, node-row
    region output and prediction of every rank has the rank's Np/P node rows
    (the single-rank run has N). Each block runs its partitioned conv once a
    forward, and its regions, EmbedT to the pre-conv and, on the dense path,
    the spatial middle (one region with ``fuse_spatial``), once a forward;
    each once more in remat's recompute."""
    _, (_, _, _, single), ranks = runs[0][name]
    keys = RUNS[name][1]
    nb = BASE["nb_block"]
    again = 2 if keys.get("remat") else 1
    dense = not keys.get("sparse")
    convs = 0 if dense else nb * again
    regions = nb * again * (2 if dense and not keys.get("fuse_spatial") else 1)
    for probe in (r[3] for r in ranks):
        kinds = [k for k, _ in probe["shapes"]]
        assert kinds.count("block") == nb and kinds.count("conv") == convs
        assert kinds.count("region") == regions and kinds.count("prediction") == 1
        assert {n for _, n in probe["shapes"]} == {probe["nloc"]}, probe["shapes"]
    assert {n for _, n in single["shapes"]} == {N}


@pytest.mark.parametrize("name", [n for n in ROWS if not RUNS[n][1].get("remat")])
def test_saved_activations_split_over_graph(runs, name):
    """What autograd saves in a rank's first forward against the
    single-rank run's, tensor by tensor in order. The node-row regions
    (EmbedT, the TAt and the pre-conv; on the dense path the spatial middle)
    keep only their inputs: each the rank's share of the tensor the single
    run gives the same computation (Np/P of N, and of the batch) or, with no
    node axis (the scores; a rank's heads under ``tp``), as the single run
    gives it or its batch share; nothing is saved inside them, where the
    single run keeps its whole activations. Outside them and the partitioned
    conv, each tensor the rank's share of the node rows or, with no node
    axis (a weight's copy, the per-sample loss terms), as the single run
    saves it (or its batch share), the rows' share more than half of the
    bytes. The partitioned conv's part is counted apart: its exchange
    brings other ranks' source rows (at this N a rank's compact table can
    hold every block)."""
    _, (_, _, _, single), ranks = runs[0][name]
    D = RUNS[name][1].get("data_axis", 1)
    dense = not RUNS[name][1].get("sparse")
    for probe in (r[3] for r in ranks):
        share = (probe["nloc"], N * D)  # (numerator, denominator)
        assert probe["each"]["temporal"] == [] and single["each"]["temporal"]
        if dense:
            assert probe["each"]["conv"] == [] and single["each"]["conv"]
        for mine, whole, kinds in ((probe["each"]["region"], single["inputs"],
                                    ((1, 1), (1, D), share)),
                                   (probe["each"]["rest"], single["each"]["rest"],
                                    ((1, 1), (1, D), share))):
            assert len(mine) == len(whole)
            assert all(any(m * den == w * num for num, den in kinds)
                       for m, w in zip(mine, whole)), (mine, whole)
        # every region keeps the rank's rows of a node-axis input
        assert sum(m * share[1] == w * share[0] and m * D != w
                   for m, w in zip(probe["each"]["region"], single["inputs"])) >= (
            len(single["inputs"]) // 2)
        rows = sum(m for m, w in zip(probe["each"]["rest"], single["each"]["rest"])
                   if m * share[1] == w * share[0] and m * D != w)
        assert 2 * rows > probe["saved"]["rest"], (rows, probe["saved"])


@pytest.mark.parametrize("case", list(REGION_CASES))
def test_region_rows_equal_the_whole_computation_bit_for_bit(runs, case):
    """The design's premise, on both ranks: a node-row region computes what
    one device computes. EmbedT, the TAt and the pre-conv inside the region,
    on the rank's rows, give the rows of the same function on the whole
    input bit for bit, its scores whole and equal, and, through the
    recompute in the backward, the same input-row and weight gradients."""
    for rank, bits in enumerate(runs[3]):
        assert bits[case] == dict(rows=True, scores=True, grads=True), (rank, bits[case])


def test_checkpoint_resume_equals_straight_run(runs):
    """Rank 0's checkpoint (whole masks and TAt weights, gathered; the Adam
    moments with them) resumed into a fresh (1, 2) trainer: epochs 2-3 and
    the test loss equal the uninterrupted run's, bit for bit."""
    ck = runs[1]
    assert ck["resumed"] == ck["straight"]
    epochs = []
    for run_dir in ck["run_dirs"]:
        events = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
        epochs.append({e["epoch"]: e["train_loss"] for e in events if e["event"] == "epoch"})
    assert epochs[0][2] == epochs[1][2] and epochs[0][3] == epochs[1][3]
    state = torch.load(os.path.join(ck["run_dirs"][0], "epoch_3.pt"), weights_only=True)
    mt = state["model"]["BlockList.0.cheb_conv_SAt.mask_tiles"]
    assert mt.ndim == 5 and mt.shape[0] == 2 and tuple(mt.shape[1:]) == ck["mask_shape"]
    assert state["model"]["BlockList.0.TAt.W_Q.weight"].shape == (2 * 8, N)  # whole
    j_mask = _jax_trainer("shape", dict(graph_axis=2, **TILES), runs[2])[1][
        "BlockList.0.cheb_conv_SAt.mask_tiles"]
    assert tuple(mt.shape) == j_mask.shape  # the JAX trainer's partitioned layout


def test_checkpoint_read_by_jax(runs):
    """A (1, 2) tp checkpoint holds whole TAt weights: JAX's
    import_torch_state_dict reads it unchanged."""
    from dstagnn_drought_tpu.config import Config as JConfig
    from dstagnn_drought_tpu.config import DataConfig as JData
    from dstagnn_drought_tpu.config import TrainingConfig as JTraining
    from dstagnn_drought_tpu.models.dstagnn import ModelSpec as JSpec
    from dstagnn_drought_tpu.models.dstagnn import import_torch_state_dict

    ck = runs[1]
    state = torch.load(os.path.join(ck["dense_dir"], "epoch_0.pt"), weights_only=True)
    spec = ModelSpec.from_config(_config(Config, DataConfig, TrainingConfig))
    params = import_torch_state_dict(
        state["model"], JSpec.from_config(_config(JConfig, JData, JTraining)))
    assert params_from_jax(params, spec).keys() == ck["dense_state"].keys()
    for k, v in params_from_jax(params, spec).items():
        np.testing.assert_array_equal(v.numpy(), ck["dense_state"][k], err_msg=k)


def test_trainer_logs_tp_report_as_jax(runs):
    """Under ``tp`` the Trainer logs JAX's ``tp_report`` of its whole
    parameters once, as the ``tp`` event of rank 0's metrics.jsonl."""
    import jax

    from dstagnn_drought_tpu.parallel.mesh import make_mesh
    from dstagnn_drought_tpu.parallel.sharding import tp_report

    ck = runs[1]
    events = [json.loads(line) for line in open(os.path.join(ck["dense_dir"], "metrics.jsonl"))]
    logged = [e for e in events if e["event"] == "tp"]
    assert len(logged) == 1
    got = {k: v for k, v in logged[0].items() if k not in ("event", "t")}
    tr = _jax_trainer("tp_report", dict(graph_axis=2, tp=True), runs[2])[0]
    assert got == tp_report(tr.params, make_mesh(1, 2, devices=jax.devices()[:2]))
    assert not got["fallback"] and got["per_device_bytes_tp"] < got["total_bytes"]


def _project(root):
    """A reference-format project: the windowed npz, headerless CSVs, the
    config."""
    A, pa, x, y = _data()
    np.savez(root / "PTOY_r1_d0_w0_dstagnn.npz", train_x=x[:4], train_target=y[:4],
             val_x=x[4:8], val_target=y[4:8], test_x=x[8:], test_target=y[8:],
             mean=np.zeros((1, 1, F, 1)), std=np.ones((1, 1, F, 1)))
    for name, a in (("adj", A), ("stag", A), ("strg", pa)):
        np.savetxt(root / f"{name}.csv", a, delimiter=",")
    training = "\n".join(f"{k} = {v}" for k, v in {**BASE, "epochs": 1}.items())
    conf = root / "PTOY.conf"
    conf.write_text(f"""[Data]
adj_filename = {root}/adj.csv
graph_signal_matrix_filename = {root}/PTOY.npz
stag_filename = {root}/stag.csv
strg_filename = {root}/strg.csv
num_of_vertices = {N}
points_per_hour = 12
num_for_predict = {PRED}
len_input = {T}
dataset_name = PTOY

[Training]
model_name = dstagnn
graph = G
num_of_hours = 1
num_of_days = 0
num_of_weeks = 0
{training}
""")
    return conf


def cli_rank(rank, conf, exp, port, flags):
    """A rank started as torchrun starts it: the environment only."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    result = train_cli.main(["--config", conf, "--experiments-root", exp, "--device", "cpu",
                             *flags])
    return result["test_loss"], torch.distributed.get_backend()


def test_cli_graph_axis_under_two_gloo_ranks(tmp_path):
    """``--graph-axis 2`` (and ``--distributed``) under two ranks started
    through RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT: gloo on the CPU, rank 0
    alone writes, and the dense model, on each rank's node rows, predicts
    what the single-process CLI predicts."""
    conf = str(_project(tmp_path))
    single = train_cli.main(["--config", conf, "--experiments-root", str(tmp_path / "one"),
                             "--device", "cpu"])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = spawn(cli_rank, 2, conf, str(tmp_path / "two"), port,
                ["--graph-axis", "2", "--distributed"], timeout=180, init=False)
    assert [o[1] for o in out] == ["gloo", "gloo"]
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][0], single["test_loss"], rtol=1e-6)
    one, two = (next((tmp_path / d / "PTOY").iterdir()) for d in ("one", "two"))
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    with np.load(next(one.glob("output_*.npz"))) as a, np.load(next(two.glob("output_*.npz"))) as b:
        np.testing.assert_allclose(b["prediction"], a["prediction"], rtol=1e-6, atol=1e-6)
    assert load_config(conf).training.graph_axis == 1  # the flags, not the file, made the mesh
