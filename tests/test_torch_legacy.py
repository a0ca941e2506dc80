"""The port's legacy loaders and STGCN-era helpers (``data/legacy.py``, a
copy of the JAX package's host numpy) on the cases of
``tests/test_legacy.py``, each function equal bit for bit to the JAX
package's on the same inputs."""
import numpy as np
import pytest

from dstagnn_drought_tpu.data import legacy as jax_legacy
from dstagnn_drought_tpu_torch.data.legacy import (
    ZScaler,
    evaluate_metric,
    evaluate_model,
    legacy_npz_path,
    load_csv_splits,
    load_windowed_dataset_legacy,
    sliding_window_transform,
)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_legacy_npz_path_suffix(tmp_path):
    p = legacy_npz_path(str(tmp_path / "PEMS04.npz"), 1, 0, 0)
    assert p.endswith("PEMS04_r1_d0_w0_mhastigcn")
    assert p == jax_legacy.legacy_npz_path(str(tmp_path / "PEMS04.npz"), 1, 0, 0)


def test_legacy_loader_slices_feature0(tmp_path):
    rng = np.random.default_rng(0)
    N, F, T = 4, 3, 5
    arrays = {}
    for split, k in (("train", 6), ("val", 3), ("test", 3)):
        arrays[f"{split}_x"] = rng.normal(size=(k, N, F, T))
        arrays[f"{split}_target"] = rng.normal(size=(k, N, T))
    arrays["mean"] = rng.normal(size=(1, 1, F, 1))
    arrays["std"] = rng.random(size=(1, 1, F, 1)) + 0.5
    sig = str(tmp_path / "FOO.npz")
    np.savez(legacy_npz_path(sig, 1, 0, 0) + ".npz", **arrays)

    ds = load_windowed_dataset_legacy(sig, 1, 0, 0)
    assert ds.train.x.shape == (6, N, 1, T)
    np.testing.assert_allclose(ds.train.x, arrays["train_x"][:, :, 0:1, :].astype(np.float32))
    np.testing.assert_allclose(ds.mean, arrays["mean"][:, :, 0:1, :])
    assert ds.test.target.shape == (3, N, T)
    jds = jax_legacy.load_windowed_dataset_legacy(sig, 1, 0, 0)
    for name in ("train", "val", "test"):
        _same(getattr(ds, name).x, getattr(jds, name).x)
        _same(getattr(ds, name).target, getattr(jds, name).target)
    _same(ds.mean, jds.mean)
    _same(ds.std, jds.std)


def test_load_csv_splits(tmp_path):
    data = np.random.default_rng(4).normal(size=(10, 2))
    p = tmp_path / "v.csv"
    np.savetxt(p, data, delimiter=",")
    train, val, test = load_csv_splits(str(p), 6, 2)
    assert train.shape == (6, 2) and val.shape == (2, 2) and test.shape == (2, 2)
    np.testing.assert_allclose(val, data[6:8])
    for a, b in zip((train, val, test), jax_legacy.load_csv_splits(str(p), 6, 2)):
        _same(a, b)
    np.savetxt(tmp_path / "one.csv", data[:, 0], delimiter=",")  # one column
    for a, b in zip(load_csv_splits(str(tmp_path / "one.csv"), 6, 2),
                    jax_legacy.load_csv_splits(str(tmp_path / "one.csv"), 6, 2)):
        assert a.shape[1] == 1
        _same(a, b)


def test_sliding_window_matches_reference_loop():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(30, 4))
    n_his, n_pred = 7, 3
    x, y = sliding_window_transform(data, n_his, n_pred)
    num = len(data) - n_his - n_pred
    assert x.shape == (num, 1, n_his, 4) and y.shape == (num, n_pred, 4)
    for i in [0, 5, num - 1]:
        np.testing.assert_allclose(x[i, 0], data[i:i + n_his], rtol=1e-6)
        np.testing.assert_allclose(y[i], data[i + n_his:i + n_his + n_pred], rtol=1e-6)
    jx, jy = jax_legacy.sliding_window_transform(data, n_his, n_pred)
    _same(x, jx)
    _same(y, jy)


def test_sliding_window_too_short():
    with pytest.raises(ValueError):
        sliding_window_transform(np.zeros((5, 2)), 4, 2)


def test_evaluate_model_weighted_mse():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(10, 1, 4, 3))
    y = rng.normal(size=(10, 2, 3))
    fn = lambda xb: xb[:, 0, :2, :]  # prediction derived from the batch
    got = evaluate_model(fn, 2, x, y, batch_size=4)
    want = float(np.mean((x[:, 0, :2, :] - y) ** 2))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == jax_legacy.evaluate_model(fn, 2, x, y, batch_size=4)


def test_evaluate_metric_wmape():
    rng = np.random.default_rng(3)
    raw = rng.random(size=(8, 2, 3)) + 1.0
    scaler = ZScaler.fit(raw)
    y = scaler.transform(raw)
    pred = y + 0.1
    fn = lambda xb: pred[: len(xb)]
    mae, rmse, wmape = evaluate_metric(fn, 2, np.zeros((8, 1, 1, 1)), y, scaler,
                                       batch_size=8)
    assert mae == pytest.approx(0.1 * scaler.std, rel=1e-5)
    assert rmse == pytest.approx(0.1 * scaler.std, rel=1e-5)
    assert wmape == pytest.approx(0.1 * scaler.std * raw.size / raw.sum(), rel=1e-5)
    jscaler = jax_legacy.ZScaler.fit(raw)
    _same(scaler.mean, jscaler.mean)
    _same(scaler.std, jscaler.std)
    _same(scaler.inverse_transform(y), jscaler.inverse_transform(y))
    assert (mae, rmse, wmape) == jax_legacy.evaluate_metric(
        fn, 2, np.zeros((8, 1, 1, 1)), y, jscaler, batch_size=8)
