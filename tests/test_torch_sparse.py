"""The port's ELL ops (``dstagnn_drought_tpu_torch/ops/sparse.py``) against
the JAX package's, on the CPU.

The same numpy-seeded inputs go to both. The ELL structure is numpy on both
sides and must agree bit for bit. The gather and the SDDMM agree to 2e-4,
the conv's forward to 2e-4 and its gradients to 5e-3 (precedents
tests/test_parity_torch.py and tests/test_pallas_cheb.py: float32 sums in
another order); both conv branches are held against JAX's, the slot loop
forced by a zero gather limit on both sides, as tests/test_sparse.py forces
JAX's scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dstagnn_drought_tpu.ops.sparse as jsp
import dstagnn_drought_tpu_torch.ops.sparse as sp

torch.set_num_threads(1)

FWD_TOL = 2e-4
GRAD_TOL = 5e-3


def _graph(rng, N, density):
    A = (rng.random((N, N)) < density).astype(np.float32)
    np.fill_diagonal(A, 0)
    return A


@pytest.mark.parametrize("max_degree, include_self", [(None, True), (2, True),
                                                      (3, False), (None, False)])
def test_ell_from_adjacency_is_bit_identical(max_degree, include_self):
    A = _graph(np.random.default_rng(0), 20, 0.2)
    got = sp.ell_from_adjacency(A, max_degree=max_degree, include_self=include_self)
    want = jsp.ell_from_adjacency(A, max_degree=max_degree, include_self=include_self)
    assert got.indices.dtype == np.int32 and got.mask.dtype == np.bool_
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    assert got.max_degree == want.max_degree
    assert got.num_edges == int(want.num_edges)
    assert torch.equal(got.tensors["indices"], torch.from_numpy(got.indices).long())


def test_ell_graph_moves_its_tensors():
    ell = sp.ell_from_adjacency(_graph(np.random.default_rng(1), 6, 0.4))
    moved = ell.to("cpu")
    assert moved.indices is ell.indices and set(moved.tensors) == {"indices", "mask"}


@pytest.mark.parametrize("padded", [False, True], ids=["square", "padded_plane"])
def test_gather_edge_values_matches_jax(padded):
    """padded: the graph has 3 more (self-loop only) nodes than the plane,
    which is zero-padded to the graph's node count first."""
    rng = np.random.default_rng(2)
    N = 12
    A = _graph(rng, N, 0.25)
    if padded:
        A = np.pad(A, ((0, 3), (0, 3)))
    dense = rng.normal(size=(3, N, N)).astype(np.float32)
    got = sp.gather_edge_values(torch.from_numpy(dense), sp.ell_from_adjacency(A))
    want = jsp.gather_edge_values(jnp.asarray(dense), jsp.ell_from_adjacency(A))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    if padded:
        assert float(got[:, N:].abs().max()) == 0.0


def test_sddmm_matches_jax():
    rng = np.random.default_rng(3)
    N, d_model, K, dk = 15, 16, 3, 8
    A = _graph(rng, N, 0.2)
    x = rng.normal(size=(2, N, d_model)).astype(np.float32)
    wq = (rng.normal(size=(d_model, K * dk)) * 0.2).astype(np.float32)
    wk = (rng.normal(size=(d_model, K * dk)) * 0.2).astype(np.float32)
    got = sp.sparse_spatial_attention_scores(
        torch.from_numpy(x), sp.ell_from_adjacency(A), wq=torch.from_numpy(wq),
        wk=torch.from_numpy(wk), n_heads=K, d_k=dk)
    want = jsp.sparse_spatial_attention_scores(
        jnp.asarray(x), jsp.ell_from_adjacency(A), wq=jnp.asarray(wq), wk=jnp.asarray(wk),
        n_heads=K, d_k=dk)
    assert got.shape == want.shape == (2, K, N, sp.ell_from_adjacency(A).max_degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)


def _conv_case(seed=4, N=18, B=2, K=2, C=3, T=5, Co=4):
    rng = np.random.default_rng(seed)
    A = _graph(rng, N, 0.3)
    E = sp.ell_from_adjacency(A).max_degree
    arrays = dict(
        x=rng.normal(size=(B, N, C, T)),
        scores=rng.normal(size=(B, K, N, E)),
        cheb=rng.normal(size=(K, N, E)),
        bias=rng.normal(size=(K, N, E)),
        thetas=rng.normal(size=(K, C, Co)) * 0.3,
        cot=rng.normal(size=(B, N, Co, T)),
    )
    return A, {k: v.astype(np.float32) for k, v in arrays.items()}


_CONV_ARGS = ("x", "scores", "cheb", "bias", "thetas")


def _jax_conv(A, a):
    ell = jsp.ell_from_adjacency(A)

    def f(x, s, cheb, bias, thetas):
        out = jsp.sparse_cheb_conv_with_sat(x, s, ell, cheb_edges=cheb, bias_edges=bias,
                                            thetas=thetas)
        return jnp.sum(out * a["cot"]), out

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(a[k]) for k in _CONV_ARGS))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_conv(A, a):
    ell = sp.ell_from_adjacency(A)
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in _CONV_ARGS}
    out = sp.sparse_cheb_conv_with_sat(t["x"], t["scores"], ell, cheb_edges=t["cheb"],
                                       bias_edges=t["bias"], thetas=t["thetas"])
    (out * torch.from_numpy(a["cot"])).sum().backward()
    return out.detach().numpy(), [t[k].grad.numpy() for k in _CONV_ARGS]


@pytest.mark.parametrize("branch", ["gather", "slot_loop"])
def test_conv_forward_and_grads_match_jax(branch, monkeypatch):
    """Both aggregation branches against JAX's same branch; the slot loop is
    forced by a zero gather limit on both sides."""
    A, a = _conv_case()
    calls = {"gather": 0, "slot_loop": 0}
    gather, slot = sp._gather_aggregate, sp._slot_loop_aggregate

    def count_gather(*args):
        calls["gather"] += 1
        return gather(*args)

    def count_slot(*args):
        calls["slot_loop"] += 1
        return slot(*args)

    monkeypatch.setattr(sp, "_gather_aggregate", count_gather)
    monkeypatch.setattr(sp, "_slot_loop_aggregate", count_slot)
    if branch == "slot_loop":
        monkeypatch.setattr(sp, "_GATHER_BYTES_LIMIT", 0)
        monkeypatch.setattr(jsp, "_GATHER_BYTES_LIMIT", 0)
    out, grads = _port_conv(A, a)
    j_out, j_grads = _jax_conv(A, a)
    assert calls == {"gather": int(branch == "gather"), "slot_loop": int(branch != "gather")}
    np.testing.assert_allclose(out, j_out, atol=FWD_TOL, rtol=FWD_TOL)
    for name, g, jg in zip(_CONV_ARGS, grads, j_grads):
        np.testing.assert_allclose(g, jg, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_slot_loop_equals_the_gather_in_the_port(monkeypatch):
    A, a = _conv_case(seed=5, B=3, K=3, C=2, T=4)
    out, grads = _port_conv(A, a)
    monkeypatch.setattr(sp, "_GATHER_BYTES_LIMIT", 0)
    out_loop, grads_loop = _port_conv(A, a)
    np.testing.assert_allclose(out_loop, out, atol=1e-5, rtol=1e-5)
    for g, gl in zip(grads, grads_loop):
        np.testing.assert_allclose(gl, g, atol=1e-5, rtol=1e-5)


def test_edge_gather_bytes_counts_the_one_shot_gather():
    ell = sp.ell_from_adjacency(np.ones((7, 7)))
    xm = torch.zeros(2, 7, 3 * 5, dtype=torch.bfloat16)
    assert sp.edge_gather_bytes(xm, ell) == 2 * 7 * 7 * 3 * 5 * 2


def test_conv_matches_the_masked_dense_oracle():
    """The port's conv against its dense masked-softmax oracle (scores from
    the dense SAt map, Chebyshev polynomials of the graph, which keep its
    pattern), and the port's oracle against JAX's."""
    from dstagnn_drought_tpu.ops.graph import cheb_polynomials, scaled_laplacian
    from dstagnn_drought_tpu_torch.ops.attention import spatial_attention_scores

    rng = np.random.default_rng(6)
    N, C, T, K, dk, d_model = 18, 4, 6, 3, 8, 16
    A = _graph(rng, N, 0.2)
    A = np.maximum(A, A.T)
    A[0, 1] = A[1, 0] = 1
    polys = np.array(cheb_polynomials(scaled_laplacian(A), K), np.float32)
    assert np.all((polys != 0) <= ((A != 0) | np.eye(N, dtype=bool))[None])
    x = rng.normal(size=(2, N, C, T)).astype(np.float32)
    emb = rng.normal(size=(2, N, d_model)).astype(np.float32)
    wq = (rng.normal(size=(d_model, K * dk)) * 0.2).astype(np.float32)
    wk = (rng.normal(size=(d_model, K * dk)) * 0.2).astype(np.float32)
    masks = rng.normal(size=(K, N, N)).astype(np.float32)
    pa = (rng.random((N, N)) < 0.3).astype(np.float32)
    thetas = (rng.normal(size=(K, C, 5)) * 0.2).astype(np.float32)
    bias = pa[None] * masks
    T_ = torch.from_numpy

    ell = sp.ell_from_adjacency(A)
    dense_scores = spatial_attention_scores(T_(emb), wq=T_(wq), wk=T_(wk), n_heads=K, d_k=dk)
    expected = sp.dense_reference_masked(T_(x), dense_scores, T_(A), cheb_polys=T_(polys),
                                         bias=T_(bias), thetas=T_(thetas))
    got = sp.sparse_cheb_conv_with_sat(
        T_(x), sp.sparse_spatial_attention_scores(T_(emb), ell, wq=T_(wq), wk=T_(wk),
                                                  n_heads=K, d_k=dk),
        ell, cheb_edges=sp.gather_edge_values(T_(polys), ell),
        bias_edges=sp.gather_edge_values(T_(bias), ell), thetas=T_(thetas))
    np.testing.assert_allclose(got.numpy(), expected.numpy(), atol=FWD_TOL, rtol=FWD_TOL)

    j_expected = jsp.dense_reference_masked(
        jnp.asarray(x), jnp.asarray(dense_scores.numpy()), jnp.asarray(A),
        cheb_polys=jnp.asarray(polys), bias=jnp.asarray(bias), thetas=jnp.asarray(thetas))
    np.testing.assert_allclose(expected.numpy(), np.asarray(j_expected), atol=FWD_TOL,
                               rtol=FWD_TOL)
