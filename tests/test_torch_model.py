"""The port's DSTAGNN model against the JAX package's, on the CPU.

The same numpy-seeded inputs and the JAX model's weights (carried across with
``params_from_jax``) go through JAX ``apply(deterministic=True)`` and the
port's forward. Forward atol 2e-4 (precedent tests/test_parity_torch.py);
SmoothL1 gradients of every parameter atol 5e-3 (precedent
tests/test_pallas_cheb.py). ``use_pallas``, ``fuse_tat``, ``fuse_spatial``
and ``fuse_gtu`` run the Pallas kernels in interpret mode on the JAX side
and the kernel modules' plain versions on the port's side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.models.dstagnn import (
    ModelSpec as JaxSpec,
    apply as jax_apply,
    import_torch_state_dict,
    make_model as jax_make_model,
)
from dstagnn_drought_tpu.ops.nn import smooth_l1_loss as jax_smooth_l1
from dstagnn_drought_tpu_torch.models.dstagnn import (
    DSTAGNN,
    ModelSpec,
    constants_from_jax,
    make_model,
    params_from_jax,
)
from dstagnn_drought_tpu_torch.ops.nn import smooth_l1_loss

torch.set_num_threads(1)

SHAPES = {
    # the test_parity_torch.py shape
    "n16_t12_f1": dict(F=1, T=12),
    # multichannel long-T: res_att mean over the feature axis, gtu_bnct tail
    "n16_t48_f4": dict(F=4, T=48),
}


def _case(F, T, seed=3):
    rng = np.random.default_rng(seed)
    N = 16
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=5, num_of_d=F,
              nb_block=2, in_channels=F, K=3, nb_chev_filter=8,
              nb_time_filter=8, d_model=24, d_k=8, n_heads=2)
    A = (rng.random((N, N)) < 0.3).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = (rng.random((N, N)) < 0.25).astype(np.float32)
    x = rng.normal(size=(3, N, F, T)).astype(np.float32)
    y = rng.normal(size=(3, N, 5)).astype(np.float32)
    jspec = JaxSpec(**kw)
    params, consts = jax_make_model(jax.random.PRNGKey(seed), jspec, A, pa)
    return ModelSpec(**kw), jspec, params, consts, x, y


def _port(spec, params, consts):
    model = DSTAGNN(spec)
    model.load_state_dict(params_from_jax(params, spec))
    return model, constants_from_jax(consts)


def _check_against_jax(shape, case=None, **flags):
    """Forward, loss and every parameter's gradient of the port against JAX
    ``apply`` with the same flags, on weights carried across (``case``: a
    ``_case``-like tuple instead of ``shape``)."""
    spec, jspec, params, consts, x, y = case or _case(**SHAPES[shape])

    def jax_loss(p):
        pred = jax_apply(p, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                         cheb_polys=consts["cheb_polys"], deterministic=True, **flags)
        return jax_smooth_l1(pred, jnp.asarray(y)), pred

    (j_loss, j_pred), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)

    model, c = _port(spec, params, consts)
    pred = model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                 deterministic=True, **flags)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(j_pred),
                               atol=2e-4, rtol=2e-4)
    loss = smooth_l1_loss(pred, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=2e-4, rtol=2e-4)

    expected = params_from_jax(j_grads, spec)
    named = dict(model.named_parameters())
    assert set(named) == set(expected)
    for name, p in named.items():
        # parameters off the path (EmbedT past block 1) have no torch grad
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), expected[name].numpy(),
                                   atol=5e-3, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_and_grads_match_jax(shape, use_pallas):
    _check_against_jax(shape, use_pallas=use_pallas)


FUSED = {"tat": dict(fuse_tat=True), "spatial": dict(fuse_spatial=True),
         "both": dict(fuse_tat=True, fuse_spatial=True)}


@pytest.mark.parametrize("fuse,shape", [
    ("tat", "n16_t12_f1"), ("spatial", "n16_t12_f1"), ("both", "n16_t12_f1"),
    # multichannel long T: the spatial kernel's output takes the (B, N, C, T) tail
    ("both", "n16_t48_f4"),
])
def test_fused_paths_match_jax(fuse, shape):
    """fuse_tat / fuse_spatial on weights from params_from_jax (no new
    mapping: the fused paths use the same parameters); the JAX kernels run
    in interpret mode, the port's wrappers their plain versions."""
    _check_against_jax(shape, **FUSED[fuse])


def test_fused_float32_matches_jax_at_a_pems07_like_shape():
    """fuse_tat and fuse_spatial together in float32 at a small PEMS07-like
    shape: N = 45 (like PEMS07's 883, a multiple of no 16-wide tile), T =
    12 → 12, F = 1, K = H = 3 as the DSTAGNN paper's PEMS07 config. The
    card runs the float32 TAt as row-tiled passes and the spatial middle
    source- and target-tiled; here both take their plain versions, against
    JAX's kernels in interpret mode."""
    rng = np.random.default_rng(11)
    N, T = 45, 12
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=12, num_of_d=1,
              nb_block=2, in_channels=1, K=3, nb_chev_filter=8, nb_time_filter=8,
              d_model=24, d_k=8, n_heads=3)
    A = (rng.random((N, N)) < 0.1).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = (rng.random((N, N)) < 0.1).astype(np.float32)
    x = rng.normal(size=(2, N, 1, T)).astype(np.float32)
    y = rng.normal(size=(2, N, 12)).astype(np.float32)
    jspec = JaxSpec(**kw)
    params, consts = jax_make_model(jax.random.PRNGKey(5), jspec, A, pa)
    _check_against_jax(None, case=(ModelSpec(**kw), jspec, params, consts, x, y),
                       fuse_tat=True, fuse_spatial=True)


def _gtu_case(T, seed=7):
    """The spec of the JAX tests/test_gtu_fused.py model tests: N=12, F=2,
    C=16, K=2, 2 blocks (C and T=48 pass the fused GTU gate)."""
    rng = np.random.default_rng(seed)
    N = 12
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=4, num_of_d=2,
              nb_block=2, in_channels=2, K=2, nb_chev_filter=16,
              nb_time_filter=16, d_model=16, d_k=8, n_heads=2)
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    A[0, 1] = A[1, 0] = 1
    pa = (rng.random((N, N)) < 0.3).astype(np.float32)
    np.fill_diagonal(pa, 1)
    x = rng.normal(size=(3, N, 2, T)).astype(np.float32)
    y = rng.normal(size=(3, N, 4)).astype(np.float32)
    jspec = JaxSpec(**kw)
    params, consts = jax_make_model(jax.random.PRNGKey(0), jspec, A, pa)
    return ModelSpec(**kw), jspec, params, consts, x, y


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_fuse_gtu_matches_jax(use_pallas):
    """fuse_gtu on both sides at T=48 (the JAX kernel in interpret mode, the
    port's plain version), on the im2col tail's parameters: forward, loss
    and every gradient; with use_pallas the tail also follows pinned_out."""
    _check_against_jax(None, case=_gtu_case(48), use_pallas=use_pallas, fuse_gtu=True)


def test_fuse_gtu_off_its_gate_gives_the_unfused_numbers(monkeypatch):
    """At T=24 the gate rejects the shape: fuse_gtu computes exactly the
    unfused numbers and never enters gtu_cat; at T=48 it does enter it."""
    from dstagnn_drought_tpu_torch.ops.cuda import gtu_fused

    def boom(*a, **k):
        raise AssertionError("gtu_cat entered")

    monkeypatch.setattr(gtu_fused, "gtu_cat", boom)
    for T in (24, 48):
        spec, _, params, consts, x, _ = _gtu_case(T, seed=11)
        model, c = _port(spec, params, consts)
        kw = dict(adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"], deterministic=True)
        with torch.no_grad():
            ref = model(torch.from_numpy(x), **kw)
            if T == 48:
                with pytest.raises(AssertionError, match="gtu_cat entered"):
                    model(torch.from_numpy(x), fuse_gtu=True, **kw)
            else:
                assert torch.equal(model(torch.from_numpy(x), fuse_gtu=True, **kw), ref)


def test_state_dict_round_trip():
    """params_from_jax ↔ import_torch_state_dict: JAX weights into the port
    and the port's own weights into JAX, both exact."""
    spec, jspec, params, consts, x, _ = _case(F=1, T=12)
    sd = params_from_jax(params, spec)
    back = import_torch_state_dict(sd, jspec)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    model, c = make_model(spec, np.eye(16, k=1) + np.eye(16, k=-1),
                          np.eye(16), seed=5, device="cpu")
    jparams = import_torch_state_dict(model.state_dict(), jspec)
    again = params_from_jax(jparams, spec)
    for name, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), again[name].numpy(), err_msg=name)
    # and the carried weights compute the same function on both sides
    out_jax = jax_apply(jparams, jnp.asarray(x), spec=jspec,
                        adj_pa=jnp.asarray(c["adj_pa"].numpy()),
                        cheb_polys=jnp.asarray(c["cheb_polys"].numpy()))
    with torch.no_grad():
        out = model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_jax), atol=2e-4, rtol=2e-4)


def test_init_matches_reference_scheme():
    """Every parameter is re-initialized like the reference: ndim > 1 →
    xavier-uniform bounds, ndim <= 1 → U(0, 1); the same seed gives the
    same weights."""
    spec, *_ = _case(F=1, T=12)
    a, _ = make_model(spec, np.eye(16), np.eye(16), seed=1, device="cpu")
    b, _ = make_model(spec, np.eye(16), np.eye(16), seed=1, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if p.ndim > 1:
            rec = int(np.prod(p.shape[2:])) if p.ndim > 2 else 1
            bound = (6.0 / ((p.shape[0] + p.shape[1]) * rec)) ** 0.5
            assert float(p.detach().abs().max()) <= bound, name
        else:
            assert 0.0 <= float(p.detach().min()) and float(p.detach().max()) <= 1.0, name


def test_entry_points_refuse_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec, *_ = _case(F=1, T=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(spec, np.eye(16), np.eye(16), seed=0, device="cuda")


# ---------------------------------------------------------------------------
# the block-sparse (BELL) branch
# ---------------------------------------------------------------------------

BELL_PATHS = {
    # path: (use_pallas, tile-resident masks)
    "plain": (False, False),
    "fused": (True, False),
    "tiles": (True, True),
}


@pytest.mark.parametrize("path", list(BELL_PATHS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bell_forward_and_grads_match_jax(shape, path):
    """The three BELL spatial paths at BS=8 against JAX ``apply(ell=bell,
    bell_tiles=...)``; the JAX kernels run in interpret mode. T=48 takes the
    (B, N, C, T) tail on the two kernel paths (pinned_out)."""
    _check_bell_against_jax(shape, path)


def test_bell_with_fused_knobs_matches_jax():
    """fuse_tat takes the temporal attention through the fused kernel on
    the BELL path too; fuse_spatial is ignored there, on both sides."""
    _check_bell_against_jax("n16_t12_f1", "tiles", fuse_tat=True, fuse_spatial=True)


def _check_bell_against_jax(shape, path, **flags):
    from dstagnn_drought_tpu.ops.block_sparse import block_ell_from_adjacency as jax_bell
    from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency

    use_pallas, tiles = BELL_PATHS[path]
    F, T = SHAPES[shape]["F"], SHAPES[shape]["T"]
    rng = np.random.default_rng(4)
    N = 16
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=5, num_of_d=F,
              nb_block=2, in_channels=F, K=2, nb_chev_filter=8,
              nb_time_filter=8, d_model=24, d_k=8, n_heads=2)
    A = (rng.random((N, N)) < 0.2).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.5) & (A > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    x = rng.normal(size=(2, N, F, T)).astype(np.float32)
    y = rng.normal(size=(2, N, 5)).astype(np.float32)
    jspec, spec = JaxSpec(**kw), ModelSpec(**kw)
    jbell, bell = jax_bell(A, block_size=8), block_ell_from_adjacency(A, block_size=8)
    params, consts = jax_make_model(jax.random.PRNGKey(1), jspec, A, pa,
                                    **({"bell": jbell} if tiles else {}))

    def jax_loss(p):
        pred = jax_apply(p, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                         cheb_polys=consts["cheb_polys"], deterministic=True,
                         use_pallas=use_pallas, ell=jbell,
                         bell_tiles=consts.get("bell_tiles"), **flags)
        return jax_smooth_l1(pred, jnp.asarray(y)), pred

    (j_loss, j_pred), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)

    model = DSTAGNN(spec, bell=bell if tiles else None)
    model.load_state_dict(params_from_jax(params, spec))
    c = constants_from_jax(consts)
    pred = model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                 deterministic=True, use_pallas=use_pallas, bell=bell,
                 bell_tiles=c.get("bell_tiles"), **flags)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(j_pred),
                               atol=2e-4, rtol=2e-4)
    loss = smooth_l1_loss(pred, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=2e-4, rtol=2e-4)
    expected = params_from_jax(j_grads, spec)
    named = dict(model.named_parameters())
    assert set(named) == set(expected)
    assert any(k.endswith("mask_tiles") for k in named) == tiles
    for name, p in named.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), expected[name].numpy(),
                                   atol=5e-3, rtol=5e-3, err_msg=name)


def test_tile_resident_init_and_constants():
    """make_model(bell=...): mask_tiles (A, K, BS, BS) drawn uniform with the
    dense xavier bound, per-tile constants instead of dense planes."""
    from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency

    spec, *_ = _case(F=1, T=12)
    A = np.eye(16, k=1) + np.eye(16, k=-1)
    bell = block_ell_from_adjacency(A, block_size=8)
    model, consts = make_model(spec, A, np.eye(16), seed=3, device="cpu", bell=bell)
    bound = (6.0 / 32) ** 0.5
    for block in model.BlockList:
        m = block.cheb_conv_SAt.mask_tiles.detach()
        assert m.shape == (bell.num_active, spec.K, 8, 8)
        assert float(m.abs().max()) <= bound and float(m.std()) > 0.3 * bound
        assert not hasattr(block.cheb_conv_SAt, "mask")
    assert consts["cheb_polys"].shape == (spec.K, 1, 1) and consts["adj_pa"].shape == (1, 1)
    assert consts["bell_tiles"]["cheb_tiles"].shape == (bell.num_active, spec.K, 8, 8)
    assert "BlockList.0.cheb_conv_SAt.mask_tiles" in model.state_dict()


# ---------------------------------------------------------------------------
# the edge-list (ELL) branch
# ---------------------------------------------------------------------------

ELL_FLAGS = {
    "plain": {},
    # use_pallas is ignored on ELL and fuse_spatial falls back to the
    # unfused middle, on both sides; fuse_tat keeps its kernel
    "knobs": dict(use_pallas=True, fuse_tat=True, fuse_spatial=True),
}


@pytest.mark.parametrize("flags", list(ELL_FLAGS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ell_forward_and_grads_match_jax(shape, flags):
    """The ELL branch against JAX ``apply(ell=...)`` on weights carried with
    ``params_from_jax`` (the dense masks, unchanged), float32: forward 2e-4,
    gradients 5e-3."""
    _check_ell_against_jax(shape, **ELL_FLAGS[flags])


def test_ell_slot_loop_matches_jax(monkeypatch):
    """The slot-loop aggregation (forced by a zero gather limit on both
    sides) through the whole model."""
    import dstagnn_drought_tpu.ops.sparse as jsp
    import dstagnn_drought_tpu_torch.ops.sparse as sp

    monkeypatch.setattr(sp, "_GATHER_BYTES_LIMIT", 0)
    monkeypatch.setattr(jsp, "_GATHER_BYTES_LIMIT", 0)
    _check_ell_against_jax("n16_t48_f4")


def test_ell_bfloat16_matches_jax():
    """bfloat16 compute on both sides, both rounding at every op with sums
    in another order: the prediction within 1e-2 of its scale (max |JAX
    prediction|), the gradient within 1e-2 of its scale as a whole
    (‖Δg‖₂ ≤ 1e-2·‖g‖₂ over every parameter). A parameter's gradient held to
    its own scale is not a bf16 criterion: on these weights the dense path
    itself differs from JAX by up to 0.42 of a small gradient's own scale
    (a mask's), with the whole gradient at 2.8e-3 (ELL 2.9e-3)."""
    _check_ell_against_jax("n16_t12_f1", dtype="bfloat16")


def _check_ell_against_jax(shape, dtype="float32", **flags):
    from dstagnn_drought_tpu.ops.sparse import ell_from_adjacency as jax_ell
    from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency

    spec, jspec, params, consts, x, y = _case(**SHAPES[shape], seed=5)
    rng = np.random.default_rng(9)
    A = (rng.random((16, 16)) < 0.2).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    jell, ell = jax_ell(A), ell_from_adjacency(A)
    j_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]

    def jax_loss(p):
        pred = jax_apply(p, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                         cheb_polys=consts["cheb_polys"], deterministic=True,
                         compute_dtype=j_dtype, ell=jell, **flags)
        return jax_smooth_l1(pred, jnp.asarray(y)), pred

    (j_loss, j_pred), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)

    sd = params_from_jax(params, spec)
    assert "BlockList.0.cheb_conv_SAt.mask.0" in sd  # ELL weights: the dense masks
    model, c = _port(spec, params, consts)
    pred = model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                 deterministic=True, compute_dtype=getattr(torch, dtype), ell=ell, **flags)
    loss = smooth_l1_loss(pred, torch.from_numpy(y))
    loss.backward()
    expected = params_from_jax(j_grads, spec)
    named = dict(model.named_parameters())
    assert set(named) == set(expected)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in named.items()}
    pred, j_pred = pred.detach().numpy(), np.asarray(j_pred)
    if dtype == "bfloat16":
        assert np.abs(pred - j_pred).max() <= 1e-2 * np.abs(j_pred).max()
        g = np.concatenate([grads[n].ravel() for n in named])
        jg = np.concatenate([expected[n].numpy().ravel() for n in named])
        assert np.linalg.norm(g - jg) <= 1e-2 * np.linalg.norm(jg)
        return
    np.testing.assert_allclose(pred, j_pred, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=2e-4, rtol=2e-4)
    for name in named:
        np.testing.assert_allclose(grads[name], expected[name].numpy(), atol=5e-3,
                                   rtol=5e-3, err_msg=name)


def test_model_refuses_both_sparse_graphs():
    from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency
    from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency

    spec, _, params, consts, x, _ = _case(F=1, T=12)
    model, c = _port(spec, params, consts)
    A = np.eye(16, k=1)
    with pytest.raises(ValueError, match="not both"):
        model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
              bell=block_ell_from_adjacency(A, block_size=8), ell=ell_from_adjacency(A))
