"""remat of the port (``torch.utils.checkpoint`` of each DSTAGNN block with
the dropout generator replayed), on the CPU: against JAX
``apply(remat=True)`` (dropout 0: prediction 2e-4, gradients 5e-3), and
against the port without remat with dropout on, from one generator seed,
on the dense, kernel (``use_pallas``), ELL, BELL-tiles and fused paths
(the kernel modules' plain versions): every gradient within 1e-6 of its
scale and the generator's state after the step equal. A control that
checkpoints without the replay must miss that bound."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from dstagnn_drought_tpu.models.dstagnn import ModelSpec as JaxSpec
from dstagnn_drought_tpu.models.dstagnn import apply as jax_apply
from dstagnn_drought_tpu.models.dstagnn import make_model as jax_make_model
from dstagnn_drought_tpu.ops.nn import smooth_l1_loss as jax_smooth_l1
from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.models import dstagnn
from dstagnn_drought_tpu_torch.models.dstagnn import (
    DSTAGNN,
    ModelSpec,
    constants_from_jax,
    make_model,
    params_from_jax,
)
from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency
from dstagnn_drought_tpu_torch.ops.nn import smooth_l1_loss
from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency
from dstagnn_drought_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)

N = 16
KW = dict(num_of_vertices=N, len_input=12, num_for_predict=5, num_of_d=1, nb_block=2,
          in_channels=1, K=2, nb_chev_filter=8, nb_time_filter=8, d_model=24, d_k=8,
          n_heads=2)


def _graphs(seed=4):
    rng = np.random.default_rng(seed)
    A = (rng.random((N, N)) < 0.2).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.5) & (A > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    x = rng.normal(size=(3, N, 1, 12)).astype(np.float32)
    y = rng.normal(size=(3, N, 5)).astype(np.float32)
    return A, pa, x, y


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_remat_matches_jax(use_pallas):
    A, pa, x, y = _graphs()
    jspec, spec = JaxSpec(**KW, dropout_rate=0.0), ModelSpec(**KW, dropout_rate=0.0)
    params, consts = jax_make_model(jax.random.PRNGKey(3), jspec, A, pa)

    def jax_loss(p):
        pred = jax_apply(p, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                         cheb_polys=consts["cheb_polys"], deterministic=False,
                         rng=jax.random.PRNGKey(0), use_pallas=use_pallas, remat=True)
        return jax_smooth_l1(pred, jnp.asarray(y)), pred

    (_, j_pred), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model = DSTAGNN(spec)
    model.load_state_dict(params_from_jax(params, spec))
    c = constants_from_jax(consts)
    pred = model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                 deterministic=False, generator=torch.Generator().manual_seed(0),
                 use_pallas=use_pallas, remat=True)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(j_pred), atol=2e-4,
                               rtol=2e-4)
    smooth_l1_loss(pred, torch.from_numpy(y)).backward()
    expected = params_from_jax(j_grads, spec)
    for name, p in model.named_parameters():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), expected[name].numpy(), atol=5e-3,
                                   rtol=5e-3, err_msg=name)


# path: (graph, tile-resident masks, flags)
PATHS = {
    "dense": (None, False, {}),
    "kernel": (None, False, dict(use_pallas=True)),
    "ell": ("ell", False, {}),
    "bell_tiles": ("bell", True, dict(use_pallas=True)),
    "fused": (None, False, dict(fuse_tat=True, fuse_spatial=True)),
}


def _step(path, remat, replay=True, monkeypatch=None):
    """One SmoothL1 backward at dropout 0.3 from generator seed 7: (the
    gradients, the generator's state after it)."""
    graph, tiles, flags = PATHS[path]
    A, pa, x, y = _graphs()
    spec = ModelSpec(**KW, dropout_rate=0.3)
    bell = block_ell_from_adjacency(A, block_size=8) if graph == "bell" else None
    model, c = make_model(spec, A, pa, seed=1, device="cpu",
                          **({"bell": bell} if tiles else {}))
    if not replay:
        def checkpoint_block(block, x, res_att, *, generator=None, **kw):
            return checkpoint(functools.partial(block, generator=generator, **kw), x,
                              res_att, use_reentrant=False)

        monkeypatch.setattr(dstagnn, "checkpoint_block", checkpoint_block)
    gen = torch.Generator().manual_seed(7)
    pred = model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                 deterministic=False, generator=gen, bell=bell,
                 bell_tiles=c.get("bell_tiles"),
                 ell=ell_from_adjacency(A) if graph == "ell" else None, remat=remat, **flags)
    smooth_l1_loss(pred, torch.from_numpy(y)).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return grads, gen.get_state()


def _worst(a, b):
    """The largest |Δ| of a gradient over its own scale."""
    assert a.keys() == b.keys()
    return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-12)
               for k in a)


@pytest.mark.parametrize("path", list(PATHS))
def test_remat_replays_dropout(path):
    eager, eager_state = _step(path, remat=False)
    remat, remat_state = _step(path, remat=True)
    assert _worst(remat, eager) <= 1e-6
    assert torch.equal(remat_state, eager_state)


@pytest.mark.parametrize("path", list(PATHS))
def test_remat_without_replay_misses(path, monkeypatch):
    """The control: the recompute draws new masks, the gradients stay finite
    but move by far more than 1e-6 of scale, and the stream runs ahead."""
    eager, eager_state = _step(path, remat=False)
    control, state = _step(path, remat=True, replay=False, monkeypatch=monkeypatch)
    assert all(bool(torch.isfinite(g).all()) for g in control.values())
    assert _worst(control, eager) > 1e-6
    assert not torch.equal(state, eager_state)


def _toy_trainer(tmp_path, **training):
    rng = np.random.default_rng(0)
    A, pa, _, _ = _graphs()
    x = rng.normal(size=(12, N, 1, 12)).astype(np.float32)
    y = rng.normal(size=(12, N, 5)).astype(np.float32)
    split = Split(x, y)
    cfg = Config(data=DataConfig(num_of_vertices=N, len_input=12, num_for_predict=5,
                                 dataset_name="REMAT"),
                 training=TrainingConfig(in_channels=1, nb_block=2, n_heads=2, K=2, d_k=8,
                                         d_model=24, nb_chev_filter=8, nb_time_filter=8,
                                         batch_size=4, **training)).validate()
    return Trainer(cfg, dataset=ArrayDataset(split, split, split, np.zeros(1), np.ones(1)),
                   adj_merge=A, adj_pa=pa, experiments_root=str(tmp_path), device="cpu")


def test_trainer_remat_epoch_equals_eager(tmp_path):
    """Trainer(remat=true): two epochs (dropout on) give the eager Trainer's
    losses and weights."""
    trs = {r: _toy_trainer(tmp_path / str(r), remat=r) for r in (False, True)}
    losses = {r: [t.train_epoch(e) for e in range(2)] for r, t in trs.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    for (k, a), b in zip(trs[True].model.state_dict().items(),
                         trs[False].model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("name", ["astgcn", "transformer"])
def test_remat_is_dstagnn_only(tmp_path, name):
    with pytest.raises(ValueError, match="remat is a dstagnn-family option"):
        _toy_trainer(tmp_path, remat=True, model_name=name)
