"""The whole-epoch runners of the port (``training/step.py``
``make_epoch_runner``/``make_eval_runner``, JAX's ``lax.scan`` programs)
on the CPU, where they run the step eagerly: against JAX's runners on the
same weights and padded batch plan (dropout 0; trajectories rtol 2e-3,
predictions 2e-4), against the eager ``train_step`` loop bit for bit with
dropout and remat on, and the Trainer's routing and graph invalidation.
The CUDA-graph capture itself runs on the card (``chip_smoke.py``
``phase_graphed``)."""
import functools

import numpy as np
import pytest
import torch

from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.models import get_family
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec, constants_from_jax, make_model
from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency
from dstagnn_drought_tpu_torch.parallel import launch
from dstagnn_drought_tpu_torch.training import checkpoint as ckpt
from dstagnn_drought_tpu_torch.training import step
from dstagnn_drought_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)

N, P, BS, LR = 12, 4, 4, 1e-3
# path: (family, widths, BELL tiles, the port's step keywords, JAX's)
PATHS = {
    "dense": ("dstagnn", dict(len_input=12, nb_chev_filter=8, nb_time_filter=8), False, {}, {}),
    "use_pallas": ("dstagnn", dict(len_input=12, nb_chev_filter=8, nb_time_filter=8), False,
                   dict(use_pallas=True), dict(use_pallas=True)),
    "bell_tiles_fuse_gtu": ("dstagnn", dict(len_input=48, nb_chev_filter=16, nb_time_filter=16),
                            True, dict(fuse_gtu=True), dict(fuse_gtu=True)),
    "astgcn": ("astgcn", dict(len_input=12, nb_chev_filter=8, nb_time_filter=8), False, {}, {}),
}


def _graph(seed=11):
    rng = np.random.default_rng(seed)
    A = (rng.random((N, N)) < 0.25).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.6) & (A > 0)).astype(np.float32)
    return A, pa


def _case(path, n=14, seed=3):
    """Both sides of ``path`` on the same weights: (JAX spec, JAX params,
    JAX constants, port model, port constants, x, y, port step keywords,
    JAX runner keywords) with ``n`` windows. JAX is imported here, so the
    ranks of the mesh test (which import this file) do not import it."""
    from dstagnn_drought_tpu.models import ModelSpec as JaxSpec
    from dstagnn_drought_tpu.models import get_family as jax_family
    from dstagnn_drought_tpu.models.dstagnn import apply as jax_apply
    from dstagnn_drought_tpu.ops.block_sparse import block_ell_from_adjacency as jax_bell

    family, widths, tiles, port_kw, jax_kw = PATHS[path]
    kw = dict(num_of_vertices=N, num_for_predict=P, num_of_d=1, nb_block=2, in_channels=1,
              K=2, d_model=16, d_k=8, n_heads=2, dropout_rate=0.0, **widths)
    jspec, spec = JaxSpec(**kw), ModelSpec(**kw)
    A, pa = _graph()
    jf, fam = jax_family(family), get_family(family)
    extra = {"bell": jax_bell(A, block_size=8)} if tiles else {}
    params, consts = jf.make_model(_jax().random.PRNGKey(seed), jspec, A, pa, **extra)
    bell = block_ell_from_adjacency(A, block_size=8) if tiles else None
    model, _ = fam.make_model(spec, A, pa, device="cpu", **({"bell": bell} if tiles else {}))
    model.load_state_dict(fam.params_from_jax(params, spec))  # before JAX donates them
    c = constants_from_jax(consts)
    if tiles:
        c["bell"] = bell
        consts = {**consts, "ell": extra["bell"]}
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, N, 1, spec.len_input)).astype(np.float32)
    y = rng.normal(size=(n, N, P)).astype(np.float32)
    apply_fn = functools.partial(jax_apply if family == "dstagnn" else jf.apply,
                                 **{k: v for k, v in jax_kw.items() if k != "use_pallas"})
    jkw = dict(apply_fn=apply_fn, use_pallas=jax_kw.get("use_pallas", False))
    return jspec, params, consts, model, c, x, y, port_kw, jkw


def _jax():
    import jax

    return jax


def _plan(n, split="train", shuffle=True):
    """The Trainer's padded batch plan of ``n`` windows: (idx (nb, B) int32,
    weights (nb, B) float32, zero on the padded tail)."""
    z = np.zeros((n, 1))
    ds = ArrayDataset(Split(z, z), Split(z, z), Split(z, z), np.zeros(1), np.ones(1))
    idx, n_valid = ds.batch_indices(split, BS, shuffle=shuffle, seed=7)
    w = (np.arange(idx.size) < n_valid).astype(np.float32).reshape(idx.shape)
    return idx, w, n_valid


@pytest.mark.parametrize("path", list(PATHS))
def test_epoch_runner_matches_jax(path):
    """One epoch of 4 steps, the last padded with a zero-weight tail: the
    per-step losses and the final weights of the port's runner against
    JAX's ``make_epoch_runner`` (rtol 2e-3 / atol 2e-4)."""
    import jax
    import jax.numpy as jnp
    from dstagnn_drought_tpu.training import step as jax_step

    jspec, params, consts, model, c, x, y, port_kw, jkw = _case(path)
    idx, w, _ = _plan(len(x))
    assert idx.shape == (4, BS) and w[-1].sum() < BS
    opt = jax_step.make_optimizer(LR)
    run = jax_step.make_epoch_runner(jspec, opt, **jkw)
    j_params, _, _, j_losses = run(params, opt.init(params), jax.random.PRNGKey(0),
                                   jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), consts,
                                   jnp.asarray(w))

    runner = step.make_epoch_runner(model, step.make_optimizer(model.parameters(), LR), c,
                                    **port_kw)
    wt = torch.from_numpy(w)
    losses = runner(torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(idx.astype(np.int64)), wt, wt.sum(dim=1))
    assert losses.shape == (4,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), rtol=2e-3, atol=2e-4)
    assert abs(float(losses[0] - losses[-1])) > 1e-4  # the trajectory moves
    want = get_family(PATHS[path][0]).params_from_jax(j_params, model.spec)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("path", ["dense", "astgcn"])
def test_eval_runner_matches_jax(path):
    """Predictions and per-sample losses of a padded split (11 windows,
    batches of 4) against JAX's ``make_eval_runner`` within 2e-4, the
    padded rows cut as ``Trainer.evaluate`` cuts them."""
    import jax.numpy as jnp
    from dstagnn_drought_tpu.training import step as jax_step

    jspec, params, consts, model, c, x, y, port_kw, jkw = _case(path, n=11)
    idx, _, n_valid = _plan(len(x), "val", shuffle=False)
    run = jax_step.make_eval_runner(jspec, **jkw)
    j_pred, j_loss = run(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), consts)
    runner = step.make_eval_runner(model, c, **port_kw)
    pred, per_sample = runner(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(idx.astype(np.int64)))
    assert pred.shape == (3, BS, N, P) and per_sample.shape == (3, BS)
    cut = lambda a: np.asarray(a).reshape(-1, *np.asarray(a).shape[2:])[:n_valid]
    np.testing.assert_allclose(cut(pred), cut(j_pred), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(cut(per_sample), cut(j_loss), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("remat", [False, True], ids=["eager_blocks", "remat"])
def test_epoch_runner_is_the_eager_loop(remat):
    """Dropout 0.3 from one generator seed, with and without remat: the
    runner's per-step losses, final weights and the generator's state equal
    the eager train_step loop's bit for bit."""
    A, pa = _graph()
    spec = ModelSpec(num_of_vertices=N, len_input=12, num_for_predict=P, num_of_d=1,
                     nb_block=2, in_channels=1, K=2, nb_chev_filter=8, nb_time_filter=8,
                     d_model=16, d_k=8, n_heads=2, dropout_rate=0.3)
    rng = np.random.default_rng(2)
    xt = torch.from_numpy(rng.normal(size=(14, N, 1, 12)).astype(np.float32))
    yt = torch.from_numpy(rng.normal(size=(14, N, P)).astype(np.float32))
    idx, w, _ = _plan(14)
    idx, wt = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(w)
    out = []
    for use_runner in (False, True):
        model, c = make_model(spec, A, pa, seed=1, device="cpu")
        opt = step.make_optimizer(model.parameters(), LR)
        gen = torch.Generator().manual_seed(5)
        if use_runner:
            losses = step.make_epoch_runner(model, opt, c, generator=gen, remat=remat)(
                xt, yt, idx, wt, wt.sum(dim=1))
        else:
            losses = torch.stack([
                step.train_step(model, opt, xt[idx[b]], yt[idx[b]], c, weights=wt[b],
                                weight_total=wt[b].sum(), generator=gen, remat=remat)
                for b in range(idx.shape[0])])
        out.append((losses, model.state_dict(), gen.get_state()))
    (l0, w0, g0), (l1, w1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert torch.equal(g0, g1)
    assert not torch.equal(g0, torch.Generator().manual_seed(5).get_state())  # dropout drew


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _config(**training) -> Config:
    return Config(data=DataConfig(num_of_vertices=N, len_input=12, num_for_predict=P,
                                  dataset_name="RUNNER"),
                  training=TrainingConfig(in_channels=1, nb_block=2, n_heads=2, K=2, d_k=8,
                                          d_model=16, nb_chev_filter=8, nb_time_filter=8,
                                          batch_size=BS, **training)).validate()


def _dataset(seed=0):
    rng = np.random.default_rng(seed)
    split = lambda n: Split(rng.normal(size=(n, N, 1, 12)).astype(np.float32),
                            rng.normal(size=(n, N, P)).astype(np.float32))
    return ArrayDataset(split(10), split(6), split(5), np.zeros(1), np.ones(1))


def _trainer(root, **training):
    A, pa = _graph()
    return Trainer(_config(**training), dataset=_dataset(), adj_merge=A, adj_pa=pa,
                   experiments_root=str(root), device="cpu")


def _count_calls(monkeypatch, owner, name):
    calls = []
    fn = getattr(owner, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(owner, name, counted)
    return calls


def test_single_rank_trainer_runs_the_runners(tmp_path, monkeypatch):
    """A single-rank run trains and evaluates through the runners (made
    once, at first use); its losses and predictions equal the eager loop's
    bit for bit."""
    runs = {}
    for graphed in (True, False):
        tr = _trainer(tmp_path / str(graphed))
        assert tr.use_runners
        epochs = _count_calls(monkeypatch, step.EpochRunner, "__call__")
        evals = _count_calls(monkeypatch, step.EvalRunner, "__call__")
        losses = [tr.train_epoch(e) if graphed else tr.train_epoch_eager(e) for e in range(2)]
        pred, loss = tr.evaluate("val") if graphed else tr.evaluate_eager("val")
        runs[graphed] = (losses, tr.last_losses, pred, loss)
        assert (len(epochs), len(evals)) == ((2, 1) if graphed else (0, 0))
        monkeypatch.undo()
        if graphed:
            assert tr.runners() == tr.runners()  # the same two runners
            assert tr.graph_stats == []  # no CUDA graph on the CPU
    assert runs[True][:2] == runs[False][:2]
    np.testing.assert_array_equal(runs[True][2], runs[False][2])
    assert runs[True][3] == runs[False][3]


def test_debug_mode_keeps_the_eager_loop(tmp_path, monkeypatch):
    tr = _trainer(tmp_path, debug=True)
    assert not tr.use_runners
    epochs = _count_calls(monkeypatch, step.EpochRunner, "__call__")
    evals = _count_calls(monkeypatch, step.EvalRunner, "__call__")
    tr.train_epoch(0)
    tr.evaluate("val")
    assert epochs == evals == [] and tr._runners is None


def _mesh_rank(rank, root):
    """A 2-rank data mesh's Trainer: no runners, its epoch is the eager
    loop's."""
    A, pa = _graph()
    tr = Trainer(_config(data_axis=2), dataset=_dataset(), adj_merge=A, adj_pa=pa,
                 experiments_root=root, device="cpu")
    loss = tr.train_epoch(0)
    tr.evaluate("val")
    return {"use_runners": tr.use_runners, "runners": tr._runners, "loss": loss}


def test_mesh_keeps_the_eager_loop(tmp_path):
    (tmp_path / "init").mkdir()
    out = launch.spawn(_mesh_rank, 2, str(tmp_path), timeout=120,
                       init_dir=str(tmp_path / "init"))
    assert [o["use_runners"] for o in out] == [False, False]
    assert [o["runners"] for o in out] == [None, None]
    assert np.isfinite(out[0]["loss"]) and out[0]["loss"] == out[1]["loss"]


def test_state_replacements_invalidate_the_graphs(tmp_path):
    """The runners are made again (their graphs captured again) after
    resume, after a rollback, after ``_load(optimizer=True)`` and where a
    constant or the compute dtype was replaced; loading weights only
    (``_load(optimizer=False)``: final_test, load_model_state) copies into
    the parameters and keeps them, as does an in-place change."""
    tr = _trainer(tmp_path, nan_policy="rollback")
    tr.train_epoch(0)
    tr._save(0, {"best_val": 1.0, "best_epoch": 0})
    state = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tr.run_dir), map_location="cpu")

    def made_again(fn):
        before = tr.runners()
        params = [p.data_ptr() for p in tr.model.parameters()]
        fn()
        assert [p.data_ptr() for p in tr.model.parameters()] == params  # in place
        return tr.runners()[0] is not before[0] and tr.runners()[1] is not before[1]

    assert not made_again(lambda: tr._load(state, optimizer=False))
    assert not made_again(lambda: tr.load_model_state(state["model"]))
    assert not made_again(lambda: tr.constants["cheb_polys"].mul_(1.0))  # in place
    assert made_again(lambda: tr._load(state, optimizer=True))
    assert made_again(tr.resume)
    assert made_again(lambda: tr._rollback_to_last_good(1))
    # a constant or the compute dtype replaced: the graphs hold the old ones
    assert made_again(lambda: tr.constants.update(cheb_polys=tr.constants["cheb_polys"] * 1))
    assert made_again(lambda: setattr(tr, "compute_dtype", torch.bfloat16))
    tr.compute_dtype = torch.float32
    assert tr.runners()[0].optimizer is tr.optimizer
    assert all(g["lr"] == tr.cfg.training.learning_rate / 2
               for g in tr.optimizer.param_groups)
    assert np.isfinite(tr.train_epoch(1))


def test_optimizer_is_capturable_on_the_card_only():
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert not step.make_optimizer(p, LR).defaults["capturable"]
    assert not step.make_optimizer(p, LR, "cpu").defaults["capturable"]
    assert step.make_optimizer(p, LR, torch.device("cuda")).defaults["capturable"]


def test_a_card_checkpoint_loads_on_the_cpu(tmp_path):
    """Adam's state saved by a capturable (card) optimizer goes into the
    CPU trainer's non-capturable one, which then steps."""
    tr = _trainer(tmp_path)
    tr.train_epoch(0)
    tr._save(0, {"best_val": 1.0, "best_epoch": 0})
    state = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tr.run_dir), map_location="cpu")
    for g in state["optimizer"]["param_groups"]:
        g["capturable"] = True
    tr._load(state)
    assert not any(g["capturable"] for g in tr.optimizer.param_groups)
    assert np.isfinite(tr.train_epoch(1))
