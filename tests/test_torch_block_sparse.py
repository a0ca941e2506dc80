"""The port's block-sparse (BELL) structures and plain BELL path
(ops/block_sparse.py) against the JAX package's, on the CPU.

Host structures are built with numpy on both sides and must be equal field
by field; the plain path (block SDDMM + neighbourhood-softmax conv) must
match in the forward (atol 2e-4) and in its gradients (atol 5e-3), the
precedents of tests/test_parity_torch.py and tests/test_pallas_cheb.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.ops import block_sparse as jbs
from dstagnn_drought_tpu_torch.ops import block_sparse as tbs

torch.set_num_threads(1)

FIELDS = ("block_idx", "block_mask", "pattern", "active_src", "active_tgt",
          "tile_start", "tile_count", "adj_bool", "active_slot", "src_order",
          "src_start", "src_count")


def _grid(nx=9, ny=5):
    N = nx * ny
    A = np.zeros((N, N), np.float32)
    idx = np.arange(N).reshape(nx, ny)
    A[idx[:-1].ravel(), idx[1:].ravel()] = 1
    A[idx[:, :-1].ravel(), idx[:, 1:].ravel()] = 1
    return np.maximum(A, A.T)


def _random(n=29, p=0.15, seed=3):
    return (np.random.default_rng(seed).random((n, n)) < p).astype(np.float32)


def _edgeless_column():
    A = _random(n=21, p=0.2, seed=4)
    A[:, 5] = 0  # node 5 has no in-edge (and no self-loop below)
    return A


GRAPHS = {
    # (adjacency, block size, include_self)
    "random": (_random(), 8, True),
    "grid": (_grid(), 16, True),
    "uncovered": (_edgeless_column(), 8, False),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_host_structures_equal_jax(name):
    adj, BS, self_loops = GRAPHS[name]
    mine = tbs.block_ell_from_adjacency(adj, block_size=BS, include_self=self_loops)
    ref = jbs.block_ell_from_adjacency(adj, block_size=BS, include_self=self_loops)
    for f in FIELDS:
        a, b = getattr(mine, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert mine.n_nodes == ref.n_nodes
    assert mine.covered == ref.covered == (name != "uncovered")
    assert mine.max_src_blocks == ref.max_src_blocks
    for f in ("block_size", "num_tiles", "max_blocks", "padded_nodes", "num_active"):
        assert getattr(mine, f) == getattr(ref, f), f
    # the device tensors carry the same arrays, indices once, as int32; the
    # (Np, Np) edge pattern stays on the host
    for f in FIELDS:
        if f == "adj_bool":
            assert f not in mine.tensors
            continue
        np.testing.assert_array_equal(mine.tensors[f].numpy(), getattr(mine, f), err_msg=f)
        assert mine.tensors[f].dtype in (torch.int32, torch.bool), f


@pytest.mark.parametrize("name", ["random", "grid"])
def test_rcm_permutation_equal_jax(name):
    adj = GRAPHS[name][0]
    rng = np.random.default_rng(1)
    shuffle = rng.permutation(adj.shape[0])
    adj = adj[np.ix_(shuffle, shuffle)]
    mine, ref = tbs.rcm_permutation(adj), jbs.rcm_permutation(adj)
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)


def test_tile_constants_equal_jax():
    adj, BS, _ = GRAPHS["random"]
    n, K = adj.shape[0], 3
    rng = np.random.default_rng(2)
    pa = ((rng.random((n, n)) < 0.5) & (adj > 0)).astype(np.float32)
    polys = rng.normal(size=(K, n, n)).astype(np.float32)
    mine = tbs.build_bell_tile_constants(
        tbs.block_ell_from_adjacency(adj, block_size=BS), pa, polys)
    ref_bell = jbs.block_ell_from_adjacency(adj, block_size=BS)
    ref = jbs.build_bell_tile_constants(ref_bell, pa, polys)
    assert set(mine) == set(ref)
    for k in ref:
        assert mine[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(
        tbs.active_tile_values(polys, tbs.block_ell_from_adjacency(adj, block_size=BS)),
        jbs.active_tile_values(polys, ref_bell))


def test_gather_and_pad_equal_jax():
    adj, BS, _ = GRAPHS["grid"]
    n = adj.shape[0]
    dense = np.random.default_rng(5).normal(size=(2, n, n)).astype(np.float32)
    mine = tbs.block_ell_from_adjacency(adj, block_size=BS)
    ref = jbs.block_ell_from_adjacency(adj, block_size=BS)
    np.testing.assert_array_equal(
        tbs.gather_block_values(torch.from_numpy(dense), mine).numpy(),
        np.asarray(jbs.gather_block_values(jnp.asarray(dense), ref)))
    x = np.ones((2, n, 3), np.float32)
    padded = tbs.pad_node_axis(torch.from_numpy(x), mine, 1)
    assert padded.shape == (2, mine.padded_nodes, 3) and float(padded[:, n:].abs().sum()) == 0


def test_graph_to_moves_the_tensors():
    g = tbs.block_ell_from_adjacency(_random(), block_size=8)
    h = g.to("cpu")
    assert set(h.tensors) == set(g.tensors)
    assert all(v.device == torch.device("cpu") for v in h.tensors.values())
    assert h.active_src is g.active_src  # host arrays are shared
    np.testing.assert_array_equal(h.tensors["active_pattern"].numpy(), g.active_pattern())


def _xla_case(seed=0, n=29, BS=8, K=2, C=3, T=6, B=2, dm=10, dk=4):
    rng = np.random.default_rng(seed)
    adj = _random(n, 0.2, seed)
    return dict(
        adj=adj, BS=BS, K=K, dk=dk,
        x=rng.normal(size=(B, n, C, T)).astype(np.float32),
        emb=rng.normal(size=(B, n, dm)).astype(np.float32),
        wq=(rng.normal(size=(dm, K * dk)) * 0.4).astype(np.float32),
        wk=(rng.normal(size=(dm, K * dk)) * 0.4).astype(np.float32),
        cheb=rng.normal(size=(K, n, n)).astype(np.float32),
        bias=(rng.normal(size=(K, n, n)) * (rng.random((n, n)) < 0.5)).astype(np.float32),
        thetas=(rng.normal(size=(K, C, 5)) * 0.3).astype(np.float32),
    )


def test_plain_bell_path_matches_jax_forward_and_grads():
    c = _xla_case()
    ref = jbs.block_ell_from_adjacency(c["adj"], block_size=c["BS"])
    mine = tbs.block_ell_from_adjacency(c["adj"], block_size=c["BS"])
    names = ("x", "emb", "wq", "wk", "bias", "thetas")

    def jax_loss(x, emb, wq, wk, bias, thetas):
        scores = jbs.block_sparse_spatial_attention_scores(
            emb, ref, wq=wq, wk=wk, n_heads=c["K"], d_k=c["dk"])
        out = jbs.block_sparse_cheb_conv_with_sat(
            x, scores, ref, cheb_blocks=jbs.gather_block_values(jnp.asarray(c["cheb"]), ref),
            bias_blocks=jbs.gather_block_values(bias, ref), thetas=thetas)
        return (out * jnp.cos(out)).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(c[k]) for k in names))

    leaves = [torch.from_numpy(c[k]).requires_grad_(True) for k in names]
    x, emb, wq, wk, bias, thetas = leaves
    scores = tbs.block_sparse_spatial_attention_scores(emb, mine, wq=wq, wk=wk,
                                                       n_heads=c["K"], d_k=c["dk"])
    out = tbs.block_sparse_cheb_conv_with_sat(
        x, scores, mine,
        cheb_blocks=tbs.gather_block_values(torch.from_numpy(c["cheb"]), mine),
        bias_blocks=tbs.gather_block_values(bias, mine), thetas=thetas)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=2e-4, rtol=2e-4)
    (out * torch.cos(out)).sum().backward()
    for leaf, jg, name in zip(leaves, j_grads, names):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), atol=5e-3, rtol=5e-3,
                                   err_msg=name)
