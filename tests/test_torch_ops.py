"""The port's tensor ops against the JAX package's, on the CPU: the same
numpy-seeded inputs through both, forward atol 2e-4 (precedent
tests/test_parity_torch.py) and ``jax.grad`` vs ``torch.autograd`` atol 5e-3
(precedent tests/test_pallas_cheb.py)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.ops import attention as j_att
from dstagnn_drought_tpu.ops import cheb as j_cheb
from dstagnn_drought_tpu.ops import graph as j_graph
from dstagnn_drought_tpu.ops import nn as j_nn
from dstagnn_drought_tpu_torch.ops import attention, cheb, graph, gtu, nn

# the JAX ops package re-exports a function named gtu over the module
j_gtu = importlib.import_module("dstagnn_drought_tpu.ops.gtu")
torch.set_num_threads(1)
FWD, GRAD = 2e-4, 5e-3


def _check(jax_fn, torch_fn, arrays, fwd=FWD, grad=GRAD):
    """Forward of both, then the gradient of sum(out * w) for a fixed random
    cotangent w with respect to every input array."""
    j_out = jax_fn(*[jnp.asarray(a) for a in arrays])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    t_out = torch_fn(*leaves)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=fwd, rtol=fwd)
    w = np.random.default_rng(99).normal(size=np.shape(j_out)).astype(np.float32)
    j_grads = jax.grad(
        lambda *a: jnp.sum(jax_fn(*a) * w), argnums=tuple(range(len(arrays)))
    )(*[jnp.asarray(a) for a in arrays])
    (t_out * torch.from_numpy(w)).sum().backward()
    for i, (leaf, jg) in enumerate(zip(leaves, j_grads)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   atol=grad, rtol=grad, err_msg=f"input {i}")


def _ring(n):
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        A[i, (i + 1) % n] = A[(i + 1) % n, i] = 1
    A[0, n // 2] = A[n // 2, 0] = 1
    return A


def test_lambda_max_matches_jax_and_eig():
    """Power iteration from another start vector: λ_max agrees with the JAX
    package's and with eigvalsh to rtol 1e-4."""
    A = _ring(23)
    L = np.diag(A.sum(1)) - A
    lam = float(graph.power_iteration_lambda_max(torch.from_numpy(L)))
    lam_jax = float(j_graph.power_iteration_lambda_max(jnp.asarray(L)))
    np.testing.assert_allclose(lam, lam_jax, rtol=1e-4)
    np.testing.assert_allclose(lam, np.linalg.eigvalsh(L.astype(np.float64)).max(), rtol=1e-4)
    np.testing.assert_allclose(
        graph.scaled_laplacian(torch.from_numpy(A)).numpy(),
        np.asarray(j_graph.scaled_laplacian(jnp.asarray(A))), atol=1e-4)


@pytest.mark.parametrize("matmul", [False, True], ids=["elementwise", "matmul"])
def test_cheb_polynomials_match_jax(rng, matmul):
    Lt = rng.normal(size=(9, 9)).astype(np.float32) * 0.5
    got = graph.cheb_polynomials(torch.from_numpy(Lt), 4, matmul=matmul).numpy()
    want = np.asarray(j_graph.cheb_polynomials(jnp.asarray(Lt), 4, matmul=matmul))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if not matmul:  # the reference's Hadamard recurrence
        np.testing.assert_allclose(got[2], 2 * Lt * Lt - np.eye(9), atol=1e-5)


@pytest.mark.parametrize("kind", graph.LAPLACIAN_KINDS)
def test_laplacian_kinds_match_jax(kind):
    """Every legacy Laplacian kind on a weighted graph with an isolated node
    (the zero-degree rows): 1e-5 of the JAX package's; the ``wid_`` kinds,
    rescaled by power iteration from another start vector, rtol 1e-4."""
    rng = np.random.default_rng(6)
    A = _ring(13) * rng.uniform(0.5, 2.0, (13, 13)).astype(np.float32)
    A = np.maximum(A, A.T)
    A[5, :] = A[:, 5] = 0
    got = graph.laplacian(torch.from_numpy(A), kind).numpy()
    want = np.asarray(j_graph.laplacian(jnp.asarray(A), kind))
    assert got.shape == want.shape == (13, 13) and got.dtype == np.float32
    tol = dict(rtol=1e-4, atol=1e-4) if kind.startswith("wid_") else dict(atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_laplacian_unknown_kind():
    with pytest.raises(ValueError, match="unknown laplacian kind"):
        graph.laplacian(np.eye(3), "magnetic")


def test_layer_norm(rng):
    x = rng.normal(size=(3, 5, 7)).astype(np.float32) * 3 + 1
    s, b = rng.random(7).astype(np.float32), rng.random(7).astype(np.float32)
    _check(j_nn.layer_norm, nn.layer_norm, [x, s, b])


def test_weighted_smooth_l1(rng):
    pred = rng.normal(size=(4, 6, 3)).astype(np.float32) * 2
    target = rng.normal(size=(4, 6, 3)).astype(np.float32)
    w = np.array([1, 1, 1, 0], np.float32)  # a padded tail row
    for weights in (None, w):
        got = nn.smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                sample_weights=None if weights is None else torch.from_numpy(weights))
        want = j_nn.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target),
                                   sample_weights=None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the padded row is out of the weighted mean
    np.testing.assert_allclose(
        float(nn.smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                sample_weights=torch.from_numpy(w))),
        float(nn.smooth_l1_loss(torch.from_numpy(pred[:3]), torch.from_numpy(target[:3]))),
        rtol=1e-6)
    _check(lambda p, t: j_nn.per_sample_smooth_l1(p, t),
           lambda p, t: nn.per_sample_smooth_l1(p, t), [pred, target])


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(2000)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = nn.dropout(x, 0.25, g1, deterministic=False)
    b = nn.dropout(x, 0.25, g2, deterministic=False)
    assert torch.equal(a, b)
    kept = a[a != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.75))
    assert 0.2 < float((a == 0).float().mean()) < 0.3
    assert nn.dropout(x, 0.25, g1, deterministic=True) is x


def test_temporal_attention_with_score_residual(rng):
    B, F, T, N, H, dk, dv = 2, 3, 6, 5, 2, 4, 3
    x = rng.normal(size=(B, F, T, N)).astype(np.float32)
    res = rng.normal(size=(B, F, H, T, T)).astype(np.float32)
    wq, wk = (rng.normal(size=(N, H * dk)).astype(np.float32) * 0.5 for _ in range(2))
    wv = rng.normal(size=(N, H * dv)).astype(np.float32) * 0.5
    wo = rng.normal(size=(H * dv, N)).astype(np.float32) * 0.5
    s, b = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    kw = dict(n_heads=H, d_k=dk, d_v=dv)

    def j_fn(x, res, wq, wk, wv, wo, s, b):
        out, scores = j_att.temporal_attention(x, res, wq=wq, wk=wk, wv=wv, wo=wo,
                                               ln_scale=s, ln_bias=b, **kw)
        return jnp.concatenate([out.reshape(-1), scores.reshape(-1)])

    def t_fn(x, res, wq, wk, wv, wo, s, b):
        out, scores = attention.temporal_attention(x, res, wq=wq, wk=wk, wv=wv, wo=wo,
                                                   ln_scale=s, ln_bias=b, **kw)
        return torch.cat([out.reshape(-1), scores.reshape(-1)])

    _check(j_fn, t_fn, [x, res, wq, wk, wv, wo, s, b])


def test_spatial_attention_scores(rng):
    B, N, D, K, dk = 2, 7, 6, 3, 4
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    wq, wk = (rng.normal(size=(D, K * dk)).astype(np.float32) for _ in range(2))
    _check(lambda x, q, k: j_att.spatial_attention_scores(x, wq=q, wk=k, n_heads=K, d_k=dk),
           lambda x, q, k: attention.spatial_attention_scores(x, wq=q, wk=k, n_heads=K, d_k=dk),
           [x, wq, wk])


def test_cheb_conv_with_sat(rng):
    B, K, N, C, T, Co = 2, 3, 9, 3, 5, 4
    x = rng.normal(size=(B, N, C, T)).astype(np.float32)
    s = rng.normal(size=(B, K, N, N)).astype(np.float32)
    pa = (rng.random((N, N)) < 0.4).astype(np.float32)
    polys = rng.normal(size=(K, N, N)).astype(np.float32)
    masks = rng.normal(size=(K, N, N)).astype(np.float32)
    th = rng.normal(size=(K, C, Co)).astype(np.float32) * 0.3
    _check(lambda x, s, m, th: j_cheb.cheb_conv_with_sat(
               x, s, jnp.asarray(pa), cheb_polys=jnp.asarray(polys), masks=m, thetas=th),
           lambda x, s, m, th: cheb.cheb_conv_with_sat(
               x, s, torch.from_numpy(pa), cheb_polys=torch.from_numpy(polys), masks=m, thetas=th),
           [x, s, masks, th])


@pytest.mark.parametrize("T", [12, 48], ids=["conv_T12", "im2col_T48"])
@pytest.mark.parametrize("k", [3, 7])
def test_gtu(rng, T, k):
    B, C, N = 2, 4, 3
    x = rng.normal(size=(B, C, N, T)).astype(np.float32)
    w = rng.normal(size=(2 * C, C, 1, k)).astype(np.float32) * 0.3
    b = rng.normal(size=(2 * C,)).astype(np.float32)
    _check(lambda x, w, b: j_gtu.gtu(x, w, b, in_channels=C),
           lambda x, w, b: gtu.gtu(x, w, b, in_channels=C), [x, w, b])


def test_gtu_bnct(rng):
    B, N, C, T, k = 2, 3, 4, 48, 5
    x = rng.normal(size=(B, N, C, T)).astype(np.float32)
    w = rng.normal(size=(2 * C, C, 1, k)).astype(np.float32) * 0.3
    b = rng.normal(size=(2 * C,)).astype(np.float32)
    _check(lambda x, w, b: j_gtu.gtu_bnct(x, w, b, in_channels=C),
           lambda x, w, b: gtu.gtu_bnct(x, w, b, in_channels=C), [x, w, b])
    # the (B, N, T_out, C) output is the legacy GTU's, transposed
    legacy = gtu.gtu(torch.from_numpy(x).permute(0, 2, 1, 3), torch.from_numpy(w),
                     torch.from_numpy(b), in_channels=C)
    bnct = gtu.gtu_bnct(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                        in_channels=C)
    torch.testing.assert_close(bnct, legacy.permute(0, 2, 3, 1), atol=1e-5, rtol=1e-5)


def test_conv2d_strided(rng):
    x = rng.normal(size=(2, 3, 4, 9)).astype(np.float32)
    w = rng.normal(size=(5, 3, 1, 1)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    _check(lambda x, w, b: j_gtu.conv2d_nchw(x, w, b, stride=(1, 2)),
           lambda x, w, b: gtu.conv2d_nchw(x, w, b, stride=(1, 2)), [x, w, b])
