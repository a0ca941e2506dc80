"""The port's native CSV bridge (``data/native.py``) and the adjacency
loaders that read through it, on the CPU: with the repository's
``native/libcsv_matrix.so`` and without it (the numpy fallback), each
equal bit for bit to the JAX package's ``load_dense_csv``; the native
parser's refusals (``tests/test_native_csv.py``)."""
import numpy as np
import pytest

from dstagnn_drought_tpu.data import adjacency as jax_adjacency
from dstagnn_drought_tpu.data.native import load_dense_csv as jax_load_dense_csv
from dstagnn_drought_tpu_torch.data import adjacency, native


@pytest.fixture
def matrix_csv(tmp_path):
    rng = np.random.default_rng(0)
    M = rng.normal(size=(37, 53)) * 10.0 ** rng.integers(-8, 8, (37, 53))
    p = tmp_path / "m.csv"
    np.savetxt(p, M, delimiter=",")
    return p


def _native():
    if not native.native_available():
        pytest.skip("native/libcsv_matrix.so is not built (make -C native)")


class _NoLibrary:
    path = "/nonexistent/libcsv_matrix.so"

    @staticmethod
    def get():
        return None


def test_native_matches_jax_bit_for_bit(matrix_csv):
    _native()
    got = native.load_dense_csv(str(matrix_csv))
    want = jax_load_dense_csv(str(matrix_csv))
    assert got.dtype == want.dtype == np.float64 and got.shape == (37, 53)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, np.loadtxt(matrix_csv, delimiter=","), rtol=1e-15)


def test_fallback_matches_jax_fallback(matrix_csv, monkeypatch):
    import dstagnn_drought_tpu.data.native as jax_native

    monkeypatch.setattr(native, "_library", _NoLibrary())
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_checked", True)
    assert not native.native_available()
    got = native.load_dense_csv(str(matrix_csv))
    assert got.tobytes() == jax_load_dense_csv(str(matrix_csv)).tobytes()
    assert got.tobytes() == np.loadtxt(matrix_csv, delimiter=",", ndmin=2).tobytes()


@pytest.mark.parametrize("text,want", [
    ("1,2\n3,4", [[1, 2], [3, 4]]),                              # no trailing newline
    ("1e-3,-2.5E2\r\n0.0,3.25\r\n", [[0.001, -250.0], [0.0, 3.25]]),  # CRLF, exponents
])
def test_native_formats(tmp_path, text, want):
    p = tmp_path / "m.csv"
    p.write_text(text)
    _native()
    got = native.load_dense_csv(str(p))
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == jax_load_dense_csv(str(p)).tobytes()


def test_native_refusals(tmp_path):
    _native()
    p = tmp_path / "m.csv"
    p.write_text("1,2,3\n4,5\n")
    with pytest.raises(IOError):
        native.load_dense_csv(str(p))
    with pytest.raises(FileNotFoundError):
        native.load_dense_csv(str(tmp_path / "missing.csv"))


def test_adjacency_loaders_read_through_the_bridge(tmp_path):
    """read_dense_csv is the bridge; the loaders built on it agree with
    JAX's bit for bit."""
    rng = np.random.default_rng(1)
    A = (rng.random((9, 9)) < 0.3) * rng.random((9, 9))
    np.fill_diagonal(A, 1)
    p = tmp_path / "a.csv"
    np.savetxt(p, A, delimiter=",")
    assert adjacency.read_dense_csv(str(p)).tobytes() == \
        jax_load_dense_csv(str(p)).tobytes()
    for ours, theirs in ((adjacency.load_stag_adjacency(str(p), 9),
                          jax_adjacency.load_stag_adjacency(str(p), 9)),
                         (adjacency.load_strg_adjacency(str(p)),
                          jax_adjacency.load_strg_adjacency(str(p))),
                         (adjacency.load_dense_adjacency(str(p), 9),
                          jax_adjacency.load_dense_adjacency(str(p), 9))):
        assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
