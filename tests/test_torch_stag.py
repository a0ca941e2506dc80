"""The port's STAG construction (``dstagnn_drought_tpu_torch/data/stag.py``)
and its two data CLIs against the JAX package's, on the CPU.

Tolerances and why:
  * Sinkhorn distances 1e-5: both sides run the same float32 log-domain
    iterations; only the log-sum-exp reduction order differs (observed
    ≤ 1e-7 on these inputs).
  * ``sta_matrix`` 1e-5: the same Sinkhorn per pair, batched, plus the
    cosine cost of a float32 batched matmul.
  * ``fast_sta_matrix`` 1e-4: a float32 SVD on either side (LAPACK here,
    XLA there); the cosine is invariant to the components' signs, and the
    test spectra are not degenerate (observed ≤ 3e-6).
  * ``sparsify`` and the CSV writer are numpy on both sides: bit for bit
    and byte for byte. Where the port computes its own STA matrix (the
    CLI), the binary stag CSV is byte-identical (the selection is the same)
    and the weighted strg CSV and the .npy agree to 1e-5 / 1e-4.
  * The windowed npz is numpy on both sides: byte for byte.
  * Against scipy's exact LP, 0.02 and the entropic upper bound, as
    tests/test_stag.py holds JAX's.
"""
import shutil

import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.data import stag as jstag
from dstagnn_drought_tpu_torch.data import stag

torch.set_num_threads(1)


def _marginals(rng, M, T):
    """M pairs of marginals with zero masses: some zero bins, and one pair
    whose p is zero throughout (all -inf potentials)."""
    p = rng.random((M, T)) + 0.05
    q = rng.random((M, T)) + 0.05
    p[0, :3] = 0
    q[1, 4:] = 0
    p[2] = 0
    p /= np.maximum(p.sum(1, keepdims=True), 1e-30)
    q /= q.sum(1, keepdims=True)
    return p.astype(np.float32), q.astype(np.float32)


def test_sinkhorn_matches_jax_with_zero_masses():
    rng = np.random.default_rng(0)
    M, T = 4, 10
    p, q = _marginals(rng, M, T)
    D = np.clip(rng.random((M, T, T)), 0, 1).astype(np.float32)
    got = stag.sinkhorn_distance(torch.from_numpy(p), torch.from_numpy(q),
                                 torch.from_numpy(D), eps=0.01, num_iters=200).numpy()
    want = [float(jstag.sinkhorn_distance(p[i], q[i], D[i], eps=0.01, num_iters=200))
            for i in range(M)]
    assert np.isfinite(got).all()
    assert got[2] == 0.0 == want[2]  # no mass: P is zero, not NaN
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # one pair without the batch axis gives the same number
    one = stag.sinkhorn_distance(torch.from_numpy(p[0]), torch.from_numpy(q[0]),
                                 torch.from_numpy(D[0]), eps=0.01, num_iters=200)
    np.testing.assert_allclose(float(one), want[0], atol=1e-5, rtol=0)


def _exact_wasserstein(p, q, D):
    """Exact OT by linprog, the reference's formulation."""
    from scipy.optimize import linprog

    size = len(p)
    A_eq = np.zeros((2 * size, size * size))
    for i in range(size):
        A_eq[i, i * size:(i + 1) * size] = 1
    for j in range(size):
        A_eq[size + j, j::size] = 1
    res = linprog(D.reshape(-1), A_eq=A_eq, b_eq=np.concatenate([p, q]), method="highs")
    return res.fun if res.success else 1.0


def test_sinkhorn_matches_the_exact_lp():
    rng = np.random.default_rng(1)
    M, T = 5, 10
    p = rng.random((M, T)) + 0.05
    p /= p.sum(1, keepdims=True)
    q = rng.random((M, T)) + 0.05
    q /= q.sum(1, keepdims=True)
    D = np.clip(rng.random((M, T, T)), 0, 1)
    D[:, np.arange(T), np.arange(T)] = 0.0
    approx = stag.sinkhorn_distance(
        torch.tensor(p, dtype=torch.float32), torch.tensor(q, dtype=torch.float32),
        torch.tensor(D, dtype=torch.float32), eps=0.005, num_iters=500).numpy()
    for i in range(M):
        exact = _exact_wasserstein(p[i], q[i], D[i])
        assert abs(approx[i] - exact) < 0.02, (approx[i], exact)
        assert approx[i] >= exact - 5e-3  # the entropic cost bounds the exact one


def _signal(rng, T=12, N=9, F=2):
    data = (rng.normal(size=(T, N, F)) + 3).astype(np.float32)
    data[3, 2, :] = 0  # a zero-norm step (norm clamped to 1e-12)
    data[:, 5, :] = 0  # a node with no signal at all
    return data


def test_sta_matrix_matches_jax_with_a_padded_last_block():
    """36 pairs in blocks of 16: the last block holds 4 pairs and 12 of
    padding."""
    data = _signal(np.random.default_rng(2))
    got = stag.sta_matrix(data, block_size=16, num_iters=100, device="cpu")
    want = jstag.sta_matrix(data, block_size=16, num_iters=100)
    assert got.dtype == np.float32 and got.shape == (9, 9)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, got.T)
    assert np.all(np.diag(got) == 0) and np.isfinite(got).all()


@pytest.mark.parametrize("with_coords", [True, False], ids=["coords", "grid_heuristic"])
def test_fast_sta_matrix_matches_jax(with_coords):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(20, 12, 2)).astype(np.float32)
    kw = dict(n_components=4, max_distance=3.0) if with_coords else {}
    coords = np.stack([np.arange(12), np.zeros(12)], 1).astype(np.float32) \
        if with_coords else None
    got = stag.fast_sta_matrix(data, coords, device="cpu", **kw)
    want = jstag.fast_sta_matrix(data, coords, **kw)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if with_coords:  # the spatial gate: exact zeros beyond the cutoff
        assert got[0, 5] == 0 and got[0, 11] == 0


@pytest.mark.parametrize("order", ["reference", "similar"])
def test_sparsify_is_bit_identical(order):
    sta = jstag.sta_matrix(_signal(np.random.default_rng(4), N=10), block_size=64,
                           num_iters=50)
    A, R = stag.sparsify(sta, 0.2, order)
    jA, jR = jstag.sparsify(sta, 0.2, order)
    assert A.dtype == jA.dtype and R.dtype == jR.dtype
    assert A.tobytes() == jA.tobytes() and R.tobytes() == jR.tobytes()
    with pytest.raises(ValueError, match="unknown order"):
        stag.sparsify(sta, 0.2, "nearest")


def test_save_stag_csvs_is_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    sta = rng.random((8, 8)).astype(np.float32)
    sta = (sta + sta.T) / 2
    np.fill_diagonal(sta, 0)
    A, R = jstag.sparsify(sta, 0.25)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths = stag.save_stag_csvs(A, R, str(tmp_path / "port"), "SET", 0.25)
    j_paths = jstag.save_stag_csvs(A, R, str(tmp_path / "jax"), "SET", 0.25)
    assert paths[0].endswith("stag_025_SET.csv") and paths[1].endswith("strg_025_SET.csv")
    for a, b in zip(paths, j_paths):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_generate_stag_round_trips_through_the_loaders(tmp_path):
    from dstagnn_drought_tpu_torch.data.adjacency import (
        load_stag_adjacency,
        load_strg_adjacency,
    )

    data = _signal(np.random.default_rng(6), T=10, N=8)
    sta, A, R, (a_path, r_path) = stag.generate_stag(
        data, "TESTSET", str(tmp_path), sparsity=0.25, block_size=8, num_iters=50,
        device="cpu")
    np.testing.assert_array_equal(load_stag_adjacency(a_path), A)
    np.testing.assert_array_equal(load_strg_adjacency(r_path), (R > 0).astype(np.float64))
    np.testing.assert_array_equal(np.load(tmp_path / "stag_025_TESTSET.npy"), sta)
    with pytest.raises(ValueError, match="unknown method"):
        stag.generate_stag(data, "X", str(tmp_path), method="exact", device="cpu")


def test_entry_points_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = _signal(np.random.default_rng(7))
    for call in (lambda: stag.sta_matrix(data), lambda: stag.fast_sta_matrix(data),
                 lambda: stag.generate_stag(data, "X", str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("method", ["sinkhorn", "fast"])
def test_stag_gen_cli_writes_the_jax_cli_files(tmp_path, method):
    from dstagnn_drought_tpu.cli import stag_gen as jax_cli
    from dstagnn_drought_tpu_torch.cli import stag_gen

    rng = np.random.default_rng(8)
    sig = np.cumsum(rng.normal(0, 0.3, (40, 10, 1)), axis=0) + 10
    np.savez(tmp_path / "SIG.npz", data=sig)
    args = ["--input", str(tmp_path / "SIG.npz"), "--dataset", "SIG", "--sparsity", "0.2",
            "--method", method, "--iters", "50", "--block-size", "64"]
    jax_cli.main(args + ["--out-dir", str(tmp_path / "jax")])
    sta, A, _, _ = stag_gen.main(args + ["--out-dir", str(tmp_path / "port"),
                                         "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["stag_020_SIG.csv", "stag_020_SIG.npy", "strg_020_SIG.csv"]
    read = lambda side, name: (tmp_path / side / name).read_bytes()
    assert read("port", "stag_020_SIG.csv") == read("jax", "stag_020_SIG.csv")
    tol = 1e-5 if method == "sinkhorn" else 1e-4
    np.testing.assert_allclose(np.load(tmp_path / "port" / "stag_020_SIG.npy"),
                               np.load(tmp_path / "jax" / "stag_020_SIG.npy"), atol=tol)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "strg_020_SIG.csv", delimiter=","),
                               np.loadtxt(tmp_path / "jax" / "strg_020_SIG.csv", delimiter=","),
                               atol=tol, rtol=0)
    assert A.sum(1).mean() == 2


def test_prepare_data_cli_writes_the_jax_cli_file(toy_project, tmp_path):
    from dstagnn_drought_tpu.cli import prepare_data as jax_cli
    from dstagnn_drought_tpu_torch.cli import prepare_data

    text = (toy_project / "TOY.conf").read_text()
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", prepare_data.main)):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(toy_project / "TOY.npz", d / "TOY.npz")
        conf = d / "TOY.conf"
        conf.write_text(text.replace(str(toy_project / "TOY.npz"), str(d / "TOY.npz")))
        main(["--config", str(conf)])
        outs[side] = (d / "TOY_r1_d0_w0_dstagnn.npz").read_bytes()
    assert outs["port"] == outs["jax"]
