"""The port's multi-device plans and placements against the JAX package's,
field by field, with no processes: the mesh factoring and its errors, the
ELL shard and halo plans, the BELL shard, tile-shard and overlap plans (on a
banded and a random graph, at P = 2 and 4, with N not divisible by the
shards' tiles), the TAt tensor-parallel slices and byte report, and the
data ranks' shares of the loss."""
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.models.dstagnn import ModelSpec as JaxSpec
from dstagnn_drought_tpu.models.dstagnn import make_model as jax_make_model
from dstagnn_drought_tpu.ops import block_sparse as jbs
from dstagnn_drought_tpu.ops import sparse as jsp
from dstagnn_drought_tpu.parallel import bell_partition as jbp
from dstagnn_drought_tpu.parallel import graph_partition as jgp
from dstagnn_drought_tpu.parallel import mesh as jmesh
from dstagnn_drought_tpu.parallel import sharding as jsh
from dstagnn_drought_tpu_torch.models.dstagnn import DSTAGNN, ModelSpec, params_from_jax
from dstagnn_drought_tpu_torch.ops import block_sparse as pbs
from dstagnn_drought_tpu_torch.ops import sparse as psp
from dstagnn_drought_tpu_torch.parallel import bell_partition as pbp
from dstagnn_drought_tpu_torch.parallel import graph_partition as pgp
from dstagnn_drought_tpu_torch.parallel import mesh as pmesh
from dstagnn_drought_tpu_torch.parallel import sharding as psh

N, BS, K = 37, 8, 2  # 5 tiles: 6 over 2 shards, 8 over 4


def _graph(kind: str) -> np.ndarray:
    if kind == "banded":
        i = np.arange(N)
        A = (np.abs(i[:, None] - i[None, :]) <= 3).astype(np.float32)
    else:
        A = (np.random.default_rng(3).random((N, N)) < 0.12).astype(np.float32)
    np.fill_diagonal(A, 0)
    return A


def _pa_cheb(A):
    rng = np.random.default_rng(4)
    pa = ((rng.random((N, N)) < 0.5) & (A > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    return pa, rng.normal(size=(K, N, N)).astype(np.float32)


def _assert_fields_equal(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, (int, tuple)):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)


def test_factor_devices_as_jax():
    for n in (1, 2, 4, 6, 8):
        assert pmesh.factor_devices(n) == jmesh.factor_devices(n)
    assert pmesh.factor_devices(8, graph_axis=2) == jmesh.factor_devices(8, graph_axis=2)
    for mod in (pmesh, jmesh):
        with pytest.raises(ValueError, match="must divide device count"):
            mod.factor_devices(8, graph_axis=3)


def test_make_mesh_one_process():
    """Without a process group the world is one rank: the 1 x 1 mesh, every
    group None; a larger mesh raises JAX's ValueError."""
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"data": 1, "graph": 1} and mesh.size == 1
    assert mesh.data_group is None and mesh.graph_group is None
    assert (pmesh.make_mesh(1, 1).d, pmesh.make_mesh(1, 1).g) == (0, 0)
    for d, g in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match=rf"data_axis\*graph_axis = {d * g} != 1 devices"):
            pmesh.make_mesh(d, g)
    with pytest.raises(ValueError, match=r"data_axis\*graph_axis = 9 != 8 devices"):
        jmesh.make_mesh(3, 3)


def test_maybe_initialize_distributed_needs_torchrun_env(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert pmesh.maybe_initialize_distributed() is False
    assert pmesh.choose_backend()[0] == ("nccl" if torch.cuda.is_available() else "gloo")


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["banded", "random"])
def test_ell_plans_equal_jax(kind, P):
    A = _graph(kind)
    ours = pgp.shard_ell(psp.ell_from_adjacency(A), P)
    theirs = jgp.shard_ell(jsp.ell_from_adjacency(A), P)
    np.testing.assert_array_equal(ours.indices, np.asarray(theirs.indices))
    np.testing.assert_array_equal(ours.mask, np.asarray(theirs.mask))
    assert ours.num_nodes == pgp.pad_nodes_for_mesh(N, P) == jgp.pad_nodes_for_mesh(N, P)
    plan, jplan = pgp.build_halo_plan(ours, P), jgp.build_halo_plan(theirs, P)
    _assert_fields_equal(plan, jplan)
    assert plan.buffer_rows == jplan.buffer_rows
    assert pgp.halo_stats(plan) == jgp.halo_stats(jplan)


def test_halo_plan_needs_a_padded_graph():
    ell = psp.ell_from_adjacency(_graph("banded"))
    with pytest.raises(ValueError, match="use shard_ell first"):
        pgp.build_halo_plan(ell, 2)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["banded", "random"])
def test_bell_plans_equal_jax(kind, P):
    A = _graph(kind)
    pa, cheb = _pa_cheb(A)
    bell = pbs.block_ell_from_adjacency(A, block_size=BS)
    jbell = jbs.block_ell_from_adjacency(A, block_size=BS)
    _assert_fields_equal(pbp.build_bell_shard_plan(bell, P), jbp.build_bell_shard_plan(jbell, P))
    plan = pbp.build_bell_tile_shard_plan(bell, P, pa, cheb)
    jplan = jbp.build_bell_tile_shard_plan(jbell, P, pa, cheb)
    _assert_fields_equal(plan, jplan)
    assert plan.halo_stats() == jplan.halo_stats()
    assert plan.padded_nodes == jplan.padded_nodes and plan.max_active == jplan.max_active
    vals = np.random.default_rng(5).normal(size=(bell.num_active, K, BS, BS)).astype(np.float32)
    np.testing.assert_array_equal(plan.pack_active(vals), jplan.pack_active(vals))
    _assert_fields_equal(pbp.build_overlap_lists(plan), jbp.build_overlap_lists(jplan))


def _tp_models(n_heads, d_k):
    spec = dict(num_of_vertices=16, len_input=12, num_for_predict=4, num_of_d=1, nb_block=2,
                in_channels=1, K=2, nb_chev_filter=8, nb_time_filter=8, d_model=16, d_k=d_k,
                n_heads=n_heads)
    rng = np.random.default_rng(0)
    A = np.maximum(rng.random((16, 16)) < 0.3, np.eye(16, dtype=bool)).astype(np.float32)
    params, _ = jax_make_model(jax.random.PRNGKey(0), JaxSpec(**spec), A, A)
    model = DSTAGNN(ModelSpec(**spec))
    model.load_state_dict(params_from_jax(params, ModelSpec(**spec)))
    return params, dict(model.named_parameters())


@pytest.mark.parametrize("G", [2, 4])
def test_tat_tp_shardings_and_report_equal_jax(G):
    params, named = _tp_models(n_heads=2, d_k=8)
    jm = jmesh.make_mesh(1, G, devices=jax.devices()[:G])
    pm = pmesh.Mesh(1, G)
    axes = psh.tat_tp_shardings(named, pm)
    jsh_tree = jsh.tat_tp_shardings(params, jm)
    for i in range(2):
        tat = jsh_tree["blocks"][i]["tat"]
        for torch_name, jax_name in (("W_Q", "wq"), ("W_K", "wk"), ("W_V", "wv"), ("fc", "wo")):
            spec = tuple(tat[jax_name].spec)
            want = {(None, "graph"): 0, ("graph", None): 1}[spec]  # torch stores (out, in)
            assert axes[f"BlockList.{i}.TAt.{torch_name}.weight"] == want
    assert len(axes) == 8
    assert psh.tp_report(named, pm) == jsh.tp_report(params, jm)


def test_tat_tp_fallback_warns_as_jax(caplog):
    """H·d_k = 3·7 = 21 does not divide over 4: the weights stay whole, with
    JAX's warning word for word, and tp_report flags the fallback."""
    params, named = _tp_models(n_heads=3, d_k=7)
    jm = jmesh.make_mesh(1, 4, devices=jax.devices()[:4])
    pm = pmesh.Mesh(1, 4)
    with caplog.at_level(logging.WARNING):
        axes = psh.tat_tp_shardings(named, pm)
        jsh.tat_tp_shardings(params, jm)
    ours, theirs = (next(r.getMessage() for r in caplog.records if r.name == name)
                    for name in (psh.__name__, jsh.__name__))
    assert ours == theirs and "fell back to REPLICATED" in ours
    assert all(a is None for a in axes.values()) and len(axes) == 8
    assert psh.tp_report(named, pm) == jsh.tp_report(params, jm)
    assert psh.tp_report(named, pm)["fallback"]


@pytest.mark.parametrize("D", [1, 2, 4])
def test_data_rank_losses_add_up_to_the_batch_loss(D):
    """smooth_l1_loss of each data rank's rows over the global batch's
    weight sum: the ranks' losses add up to JAX's loss of the whole batch
    (its padded tail weighted out), and on one rank the total changes no
    bit."""
    from dstagnn_drought_tpu.ops.nn import smooth_l1_loss as jax_loss
    from dstagnn_drought_tpu_torch.ops.nn import smooth_l1_loss

    rng = np.random.default_rng(D)
    pred, y = (rng.normal(size=(8, 5, 3)).astype(np.float32) * 2 for _ in range(2))
    w = (np.arange(8) < 6).astype(np.float32)
    total = torch.tensor(w.sum())
    rows = [psh.batch_sharding(pmesh.Mesh(D, 1, d=d), 8) for d in range(D)]
    parts = [smooth_l1_loss(torch.from_numpy(pred[r]), torch.from_numpy(y[r]),
                            sample_weights=torch.from_numpy(w[r]), weight_total=total)
             for r in rows]
    want = float(jax_loss(pred, y, sample_weights=w))
    np.testing.assert_allclose(float(sum(parts)), want, rtol=1e-6)
    whole = smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(y),
                           sample_weights=torch.from_numpy(w))
    if D == 1:
        assert torch.equal(parts[0], whole)


def test_batch_rows_and_param_layout():
    mesh = pmesh.Mesh(2, 2, d=1, g=1)
    assert psh.batch_sharding(mesh, 8) == slice(4, 8)
    x = torch.ones(2, 3)
    with pytest.raises(ValueError, match="must divide over data_axis=2"):
        psh.batch_sharding(mesh, 3)
    layout = psh.ParamLayout(mesh, {"BlockList.0.TAt.W_Q.weight": 0}, tiles=True)
    whole = torch.arange(2 * 3 * 1 * 2 * 2, dtype=torch.float32).reshape(2, 3, 1, 2, 2)
    name = "BlockList.0.cheb_conv_SAt.mask_tiles"
    assert layout.sliced(name) and not layout.sliced("final_fc.weight")
    torch.testing.assert_close(layout.local(name, whole), whole[1])
    assert layout.local("final_fc.weight", x) is x
