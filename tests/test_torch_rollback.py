"""NaN rollback of the port (``nan_policy = rollback``), on the CPU: the JAX
test's cases (``tests/test_nan_rollback.py``), the state right after a
rollback (the checkpoint's model, Adam moments and generator; every param
group's lr halved, not only the scale), the rollbacks running out, and the
post-rollback epoch losses against JAX's on the same weights (rtol 2e-3,
dropout 0)."""
import json

import jax
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.config import Config as JaxConfig
from dstagnn_drought_tpu.config import DataConfig as JaxDataConfig
from dstagnn_drought_tpu.config import TrainingConfig as JaxTrainingConfig
from dstagnn_drought_tpu.data.dataset import ArrayDataset as JaxDataset
from dstagnn_drought_tpu.data.dataset import Split as JaxSplit
from dstagnn_drought_tpu.training import checkpoint as jax_ckpt
from dstagnn_drought_tpu.training.loop import Trainer as JaxTrainer
from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.models.dstagnn import params_from_jax
from dstagnn_drought_tpu_torch.training import checkpoint as ckpt
from dstagnn_drought_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)

TRAINING = dict(in_channels=1, nb_block=2, n_heads=2, K=2, d_k=8, d_model=16,
                nb_chev_filter=8, nb_time_filter=8, batch_size=8, epochs=4,
                learning_rate=3e-3)


def _cfg(N, policy, max_rollbacks=2, config=(Config, DataConfig, TrainingConfig), **kw):
    C, D, T = config
    return C(
        data=D(num_of_vertices=N, len_input=12, num_for_predict=4, dataset_name="NANTOY"),
        training=T(**TRAINING, nan_policy=policy, max_rollbacks=max_rollbacks, **kw),
    ).validate()


def _arrays(rng, N, n=16):
    return [(rng.normal(size=(k, N, 1, 12)).astype(np.float32),
             rng.normal(size=(k, N, 4)).astype(np.float32)) for k in (n, 8, 8)]


def _dataset(arrays, split=Split, dataset=ArrayDataset):
    return dataset(*(split(x, y) for x, y in arrays), mean=np.zeros(1), std=np.ones(1))


def _graphs(rng, N):
    A = (rng.random((N, N)) < 0.3).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    A[0, 1] = A[1, 0] = 1
    pa = (rng.random((N, N)) < 0.2).astype(np.float32)
    return A, pa


def _trainer(root, policy, seed=0, **kw):
    rng = np.random.default_rng(seed)
    A, pa = _graphs(rng, 12)
    return Trainer(_cfg(12, policy, **kw), dataset=_dataset(_arrays(rng, 12)),
                   adj_merge=A, adj_pa=pa, experiments_root=str(root), device="cpu")


def _save(tr, epoch):
    ckpt.save_checkpoint(tr.run_dir, epoch, model_state=tr.model.state_dict(),
                         optimizer_state=tr.optimizer.state_dict(),
                         generator_state=tr.generator.get_state(), metadata={})


def _flaky(tr, failures=1):
    """The instance's train_epoch raising an injected NaN ``failures``
    times, then training."""
    orig = tr.train_epoch
    calls = {"n": 0}

    def flaky_epoch(epoch):
        calls["n"] += 1
        if calls["n"] <= failures:
            raise FloatingPointError("injected NaN")
        return orig(epoch)

    tr.train_epoch = flaky_epoch
    return calls


@pytest.mark.parametrize("policy", ["abort", "rollback"])
def test_nan_policy(tmp_path, policy):
    tr = _trainer(tmp_path / policy, policy)
    # one clean epoch so a good checkpoint exists
    loss0 = tr.train_epoch(0)
    assert np.isfinite(loss0)
    tr.epoch = 1
    _save(tr, 0)
    _flaky(tr)
    if policy == "abort":
        with pytest.raises(FloatingPointError):
            tr.run(epochs=3)
    else:
        result = tr.run(epochs=3)
        assert tr._rollbacks == 1
        assert tr._lr_scale == 0.5
        assert np.isfinite(result["test_loss"])
        events = [json.loads(line) for line in
                  open(f"{tr.run_dir}/metrics.jsonl").read().splitlines()]
        rb = [e for e in events if e["event"] == "rollback"]
        assert len(rb) == 1
        assert rb[0]["epoch"] == 1 and rb[0]["rollbacks"] == 1
        assert rb[0]["lr"] == pytest.approx(TRAINING["learning_rate"] / 2)
        assert rb[0]["checkpoint"].endswith("epoch_0.pt")
        assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2]


def test_rollback_without_checkpoint_aborts(tmp_path):
    tr = _trainer(tmp_path / "nockpt", "rollback", seed=1)
    _flaky(tr, failures=10)
    with pytest.raises(FloatingPointError, match="no checkpoint"):
        tr.run(epochs=2)


def test_rollbacks_run_out(tmp_path):
    """After max_rollbacks rollbacks the next NaN is raised, not retried."""
    tr = _trainer(tmp_path, "rollback", max_rollbacks=2)
    tr.train_epoch(0)
    tr.epoch = 1
    _save(tr, 0)
    calls = _flaky(tr, failures=10)
    with pytest.raises(FloatingPointError, match="injected NaN"):
        tr.run(epochs=3)
    assert tr._rollbacks == 2 and calls["n"] == 3
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(TRAINING["learning_rate"] / 4)


def test_rollback_restores_the_checkpoint(tmp_path):
    """Right after a rollback: the model, the Adam moments and step count and
    the generator equal the checkpoint's, and every param group's lr is the
    halved one (Adam's load_state_dict brings back the saved lr; the halved
    one is set after it)."""
    tr = _trainer(tmp_path, "rollback", dropout=0.3)
    tr.train_epoch(0)
    _save(tr, 0)
    saved = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tr.run_dir))
    tr.train_epoch(1)  # moves the model, the moments and the generator on
    assert not torch.equal(tr.generator.get_state(), saved["generator"])
    tr._rollback_to_last_good(2)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    now = tr.optimizer.state_dict()
    for p, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(now["state"][p][k], v), (p, k)
    assert torch.equal(tr.generator.get_state(), saved["generator"])
    assert [g["lr"] for g in tr.optimizer.param_groups] == [TRAINING["learning_rate"] / 2]
    assert saved["optimizer"]["param_groups"][0]["lr"] == TRAINING["learning_rate"]


def test_rollback_matches_jax(tmp_path):
    """The JAX test's flow on both sides from JAX's weights (dropout 0): a
    clean epoch 0, its checkpoint, one injected NaN at epoch 1, the
    rollback, epochs 1 and 2 at the halved lr: the logged epoch losses
    agree to rtol 2e-3."""
    rng = np.random.default_rng(0)
    A, pa = _graphs(rng, 12)
    arrays = _arrays(rng, 12)
    jtr = JaxTrainer(_cfg(12, "rollback", dropout=0.0,
                          config=(JaxConfig, JaxDataConfig, JaxTrainingConfig)),
                     dataset=_dataset(arrays, JaxSplit, JaxDataset), adj_merge=A, adj_pa=pa,
                     experiments_root=str(tmp_path / "jax"))
    tr = Trainer(_cfg(12, "rollback", dropout=0.0), dataset=_dataset(arrays), adj_merge=A,
                 adj_pa=pa, experiments_root=str(tmp_path / "port"), device="cpu")
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.params), tr.spec))
    losses = {}
    for side, t in (("jax", jtr), ("port", tr)):
        first = t.train_epoch(0)
        t.epoch = 1
        if side == "jax":
            jax_ckpt.save_checkpoint(t.run_dir, 0, params=t.params, opt_state=t.opt_state,
                                     rng=t.rng, metadata={})
            orig = type(t).train_epoch
            calls = {"n": 0}

            def flaky_epoch(self, epoch):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise FloatingPointError("injected NaN")
                return orig(self, epoch)

            type(t).train_epoch = flaky_epoch
            try:
                t.run(epochs=3)
            finally:
                type(t).train_epoch = orig
        else:
            _save(t, 0)
            _flaky(t)
            t.run(epochs=3)
        events = [json.loads(line) for line in
                  open(f"{t.run_dir}/metrics.jsonl").read().splitlines()]
        losses[side] = [first] + [e["train_loss"] for e in events if e["event"] == "epoch"]
        assert t._rollbacks == 1
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2e-3)
