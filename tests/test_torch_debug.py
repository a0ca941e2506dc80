"""Debug mode of the port (the sanitizer step, counterpart of the JAX
package's ``checkify`` step), on the CPU: the JAX test's two cases
(``tests/test_checkify.py``), the checked step equal to the unchecked one
bit for bit, an out-of-range batch index refused before the gather, a
kernel's NaN named by the kernel (on the CPU its plain version runs inside
the kernel's check; a raw write that no dispatch mode sees is named by the
kernel too), every kernel launch tagged with its kernel, and one debug
epoch of the JAX toy against JAX's (rtol 2e-3, dropout 0)."""
import jax
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.config import Config as JaxConfig
from dstagnn_drought_tpu.config import DataConfig as JaxDataConfig
from dstagnn_drought_tpu.config import TrainingConfig as JaxTrainingConfig
from dstagnn_drought_tpu.data.dataset import ArrayDataset as JaxDataset
from dstagnn_drought_tpu.data.dataset import Split as JaxSplit
from dstagnn_drought_tpu.training.loop import Trainer as JaxTrainer
from dstagnn_drought_tpu_torch import debug
from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.models.dstagnn import params_from_jax
from dstagnn_drought_tpu_torch.ops.cuda import (
    bell_bwd,
    bell_fused,
    block_spatial_fused,
    cheb_sat,
    gtu_fused,
    tat_fused,
)
from dstagnn_drought_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)


def _arrays(rng, N=8, F=1, n=16, nan_sample=None):
    x = rng.normal(size=(n, N, F, 12)).astype(np.float32)
    if nan_sample is not None:
        x[nan_sample, 0, 0, 0] = np.nan
    y = np.repeat(x[:, :, -1, :].mean(axis=2, keepdims=True), 6, axis=2).astype(np.float32)
    return x, y


def _toy(x, y, F=1, split=Split, dataset=ArrayDataset):
    sp = lambda s: split(x[s], y[s])
    return dataset(train=sp(slice(0, 8)), val=sp(slice(8, 12)), test=sp(slice(12, 16)),
                   mean=np.zeros((1, 1, F, 1)), std=np.ones((1, 1, F, 1)))


TRAINING = dict(in_channels=1, nb_block=1, n_heads=2, K=2, d_k=4, d_model=8,
                nb_chev_filter=4, nb_time_filter=4, batch_size=4, epochs=1,
                learning_rate=3e-3, debug=True)


def _cfg(N, name, **training):
    return Config(
        data=DataConfig(num_of_vertices=N, len_input=12, num_for_predict=6, dataset_name=name),
        training=TrainingConfig(**{**TRAINING, **training}),
    ).validate()


def graphs(rng, N):
    A = (rng.random((N, N)) < 0.3).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    A[0, 1] = A[1, 0] = 1
    pa = (rng.random((N, N)) < 0.2).astype(np.float32)
    return A, pa


def _trainer(tmp_path, seed=0, nan_sample=None, **training):
    rng = np.random.default_rng(seed)
    A, pa = graphs(rng, 8)
    x, y = _arrays(rng, nan_sample=nan_sample)
    return Trainer(_cfg(8, "CHK", **training), dataset=_toy(x, y), adj_merge=A, adj_pa=pa,
                   experiments_root=str(tmp_path), device="cpu")


def test_debug_mode_trains_clean_data(tmp_path):
    tr = _trainer(tmp_path)
    assert tr.checked_step is not None
    loss = tr.train_epoch(0)
    assert np.isfinite(loss)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_debug_mode_localizes_seeded_nan(tmp_path, use_pallas):
    """One poisoned training sample: the gather that emits the NaN is named,
    with the batch that holds the sample and the source line."""
    tr = _trainer(tmp_path, seed=1, nan_sample=3, use_pallas=use_pallas)
    idx, _ = tr.dataset.batch_indices("train", 4, shuffle=True, seed=tr.cfg.training.seed * 100003)
    batch = int(np.nonzero((idx == 3).any(axis=1))[0][0])
    with pytest.raises(FloatingPointError, match="nan") as err:
        tr.train_epoch(0)
    assert isinstance(err.value, debug.NonFiniteError)
    assert f"aten.index.Tensor at batch {batch}" in str(err.value)
    assert "training/step.py" in str(err.value)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_checked_step_equals_unchecked_bit_for_bit(tmp_path, use_pallas):
    """Same seed, dropout on: a debug epoch and an eager epoch give the same
    loss and the same weights, bit for bit."""
    trs = {d: _trainer(tmp_path / str(d), debug=d, dropout=0.3, use_pallas=use_pallas)
           for d in (False, True)}
    losses = {d: [t.train_epoch(e) for e in range(2)] for d, t in trs.items()}
    assert losses[True] == losses[False]
    for (k, a), b in zip(trs[True].model.state_dict().items(),
                         trs[False].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(trs[True].generator.get_state(), trs[False].generator.get_state())


class _NoGather:
    """A split that fails if it is indexed."""
    shape = (16, 8, 1, 12)
    device = torch.device("cpu")

    def __getitem__(self, i):
        raise AssertionError("gathered")


def test_out_of_range_index_raises_before_the_gather(tmp_path):
    tr = _trainer(tmp_path)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for bad in ([0, 1, 2, 16], [-1, 0, 1, 2]):
        with pytest.raises(debug.BatchIndexError, match="before the gather"):
            tr.checked_step(tr.model, tr.optimizer, _NoGather(), _NoGather(), np.array(bad),
                            tr.constants, batch=7)
    with pytest.raises(IndexError, match="at batch 7"):
        tr.checked_step(tr.model, tr.optimizer, _NoGather(), _NoGather(), np.array([16]),
                        tr.constants, batch=7)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(AssertionError, match="gathered"):  # in range: the gather runs
        tr.checked_step(tr.model, tr.optimizer, _NoGather(), _NoGather(), np.arange(4),
                        tr.constants, batch=0)


def test_kernel_poison_is_named_by_the_kernel(tmp_path):
    """An inf in a Chebyshev plane reaches no op before the cheb_sat kernel
    (here its plain version): the error names the kernel."""
    tr = _trainer(tmp_path, use_pallas=True)
    tr.constants["cheb_polys"][1, 0, 1] = float("inf")
    with pytest.raises(debug.NonFiniteError, match=r"the cheb_sat kernel at batch 0"):
        tr.train_epoch(0)


def test_raw_write_is_named_by_the_kernel():
    """A launch that writes through a raw pointer (here numpy's view of the
    buffer) is invisible to the dispatch mode: without the kernel's check
    the next aten op would be named."""
    def launch(x):
        out = torch.zeros_like(x)
        out.numpy()[1] = np.nan  # no aten op sees this write
        return out

    x = torch.ones(4)
    with debug.checking(batch=2):
        with pytest.raises(debug.NonFiniteError, match=r"nan emitted by aten.relu"):
            torch.relu(launch(x))
        with pytest.raises(debug.NonFiniteError,
                           match=r"nan emitted by the fake kernel at batch 2"):
            torch.relu(debug.kernel("fake")(launch)(x))
    torch.relu(debug.kernel("fake")(launch)(x))  # outside the region: no check


def test_inf_fill_constants_are_not_emitted():
    """A -inf fill (a masking constant) and what carries it are not faults;
    an inf that an op makes from finite inputs is."""
    with debug.checking(batch=0):
        m = torch.full((3,), -float("inf"))
        torch.maximum(m, torch.zeros(3))
        with pytest.raises(debug.NonFiniteError, match=r"inf emitted by aten.div"):
            torch.ones(2) / torch.zeros(2)


def test_backward_fault_names_the_autograd_node():
    a = torch.tensor([0.0, 1.0], requires_grad=True)
    with debug.checking(batch=5):
        with pytest.raises(debug.NonFiniteError, match=r"in the backward of SqrtBackward0 "
                                                       r"at batch 5"):
            torch.sqrt(a).sum().backward()


LAUNCHES = [
    (cheb_sat, "sat_aggregate_cuda", "cheb_sat"), (cheb_sat, "sat_aggregate_plain", "cheb_sat"),
    (bell_fused, "bell_forward_cuda", "bell_fused"),
    (bell_fused, "bell_forward_plain", "bell_fused"),
    (bell_bwd, "bell_k1_cuda", "bell_k1"), (bell_bwd, "bell_k1_plain", "bell_k1"),
    (bell_bwd, "bell_k2_cuda", "bell_k2"), (bell_bwd, "bell_k2_plain", "bell_k2"),
    (tat_fused, "tat_forward_cuda", "tat_fwd"), (tat_fused, "tat_fused_plain", "tat_fwd"),
    (tat_fused, "tat_backward_cuda", "tat_bwd"),
    (block_spatial_fused, "spatial_forward_cuda", "spatial_fwd"),
    (block_spatial_fused, "spatial_middle_plain", "spatial_fwd"),
    (block_spatial_fused, "spatial_backward_cuda", "spatial_bwd"),
    (gtu_fused, "gtu_forward_cuda", "gtu_fwd"), (gtu_fused, "gtu_cat_plain", "gtu_fwd"),
    (gtu_fused, "gtu_backward_cuda", "gtu_bwd"),
]


@pytest.mark.parametrize("module,name,kernel", LAUNCHES,
                         ids=[f"{m.__name__.split('.')[-1]}.{n}" for m, n, _ in LAUNCHES])
def test_every_launch_is_checked_by_its_kernel(module, name, kernel):
    assert getattr(module, name).kernel_name == kernel


def test_debug_epoch_matches_jax(tmp_path):
    """One debug epoch of the JAX toy (dropout 0) from JAX's weights: the
    port's mean loss within rtol 2e-3 of JAX's checkify epoch."""
    rng = np.random.default_rng(0)
    A, pa = graphs(rng, 8)
    x, y = _arrays(rng)
    jcfg = JaxConfig(
        data=JaxDataConfig(num_of_vertices=8, len_input=12, num_for_predict=6,
                           dataset_name="CHK_OK"),
        training=JaxTrainingConfig(**TRAINING, dropout=0.0)).validate()
    jtr = JaxTrainer(jcfg, dataset=_toy(x, y, split=JaxSplit, dataset=JaxDataset),
                     adj_merge=A, adj_pa=pa, experiments_root=str(tmp_path / "jax"))
    tr = Trainer(_cfg(8, "CHK_OK", dropout=0.0), dataset=_toy(x, y), adj_merge=A, adj_pa=pa,
                 experiments_root=str(tmp_path / "port"), device="cpu")
    tr.model.load_state_dict(params_from_jax(jax.device_get(jtr.params), tr.spec))
    want = jtr.train_epoch(0)
    got = tr.train_epoch(0)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=2e-3)
