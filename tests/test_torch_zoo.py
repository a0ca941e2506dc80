"""The port's model zoo (ASTGCN, MSTGCN, STGCN, Transformer) against the JAX
package's, on the CPU.

The shapes of tests/test_model_zoo.py (N=10, T=12, C=8, d_model=16). The
same numpy-seeded x goes through JAX ``apply`` and the port's forward, with
the JAX weights carried across by each family's ``params_from_jax`` and the
Chebyshev stack by ``constants_from_jax`` (the λ_max start vectors differ).
Forward atol 2e-4, every gradient 5e-3, a 3-step SmoothL1 + Adam
trajectory rtol 2e-3 / atol 2e-4 (dropout 0), as for DSTAGNN
(tests/test_torch_model.py, tests/test_torch_training.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.models import ModelSpec as JaxSpec
from dstagnn_drought_tpu.models import get_family as jax_family
from dstagnn_drought_tpu.ops.nn import smooth_l1_loss as jax_smooth_l1
from dstagnn_drought_tpu.training.step import make_optimizer as jax_optimizer
from dstagnn_drought_tpu.training.step import make_train_step
from dstagnn_drought_tpu_torch.models import get_family
from dstagnn_drought_tpu_torch.models import transformer
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec, constants_from_jax
from dstagnn_drought_tpu_torch.ops.nn import smooth_l1_loss
from dstagnn_drought_tpu_torch.training.step import make_optimizer, train_step

torch.set_num_threads(1)

FAMILIES = ["astgcn", "mstgcn", "stgcn", "transformer"]
N, T, P = 10, 12, 6


def _kw(**over):
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=P, num_of_d=1, nb_block=2,
              in_channels=1, K=3, nb_chev_filter=8, nb_time_filter=8, d_model=16, d_k=8,
              n_heads=2)
    return {**kw, **over}


def _ring(n=N):
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        A[i, (i + 1) % n] = A[(i + 1) % n, i] = 1
    return A


def _case(name, seed=0, batch=4, **over):
    """(JAX family, port spec, JAX spec, JAX params, JAX constants, x, y)."""
    kw = _kw(**over)
    jspec, spec = JaxSpec(**kw), ModelSpec(**kw)
    jf = jax_family(name)
    params, consts = jf.make_model(jax.random.PRNGKey(seed), jspec, _ring(), _ring())
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, N, 1, T)).astype(np.float32)
    y = rng.normal(size=(batch, N, P)).astype(np.float32)
    return jf, spec, jspec, params, consts, x, y


def _port(name, spec, params, consts):
    """The port's model (built by its ``make_model`` on the CPU) with the JAX
    weights, and the JAX constants as tensors."""
    fam = get_family(name)
    model, _ = fam.make_model(spec, _ring(), _ring(), device="cpu")
    model.load_state_dict(fam.params_from_jax(params, spec))
    return model, constants_from_jax(consts)


def _forward(model, c, x, **kw):
    return model(torch.from_numpy(x), adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                 deterministic=True, **kw)


def _jax_forward(jf, params, jspec, consts, x, **kw):
    return np.asarray(jf.apply(params, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                               cheb_polys=consts["cheb_polys"], deterministic=True, **kw))


@functools.lru_cache(maxsize=None)
def _against_jax(name, **over):
    """Forward, SmoothL1 loss and every parameter's gradient on both sides:
    (port pred, JAX pred, port loss, JAX loss, port grads, JAX grads)."""
    jf, spec, jspec, params, consts, x, y = _case(name, **over)

    def jax_loss(p):
        pred = jf.apply(p, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                        cheb_polys=consts["cheb_polys"], deterministic=True)
        return jax_smooth_l1(pred, jnp.asarray(y)), pred

    (j_loss, j_pred), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model, c = _port(name, spec, params, consts)
    pred = _forward(model, c, x)
    loss = smooth_l1_loss(pred, torch.from_numpy(y))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    expected = {n: g.numpy() for n, g in get_family(name).params_from_jax(j_grads, spec).items()}
    return pred.detach().numpy(), np.asarray(j_pred), loss.item(), float(j_loss), grads, expected


def _check_forward(name, **over):
    pred, j_pred, loss, j_loss = _against_jax(name, **over)[:4]
    assert pred.shape == (4, N, P)
    np.testing.assert_allclose(pred, j_pred, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(loss, j_loss, atol=2e-4, rtol=2e-4)


def _check_gradients(name, **over):
    grads, expected = _against_jax(name, **over)[4:]
    assert set(grads) == set(expected)
    for n in grads:
        np.testing.assert_allclose(grads[n], expected[n], atol=5e-3, rtol=5e-3, err_msg=n)
    assert sum(np.abs(g).sum() for g in grads.values()) > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    _check_forward(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax(name):
    _check_gradients(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_bfloat16_forward_matches_jax(name):
    """bfloat16 on both sides: weights, x and ``cheb_polys`` cast at the top
    of the forward, float32 out. Both round at every op but in other places
    (JAX's CPU convolutions, its fused elementwise chains), and at these
    widths a LayerNorm over 8 channels and a head summing signed terms
    magnify one ulp: JAX's own bf16 STGCN is up to 2.4e-2 of scale from its
    float32 prediction, so the two bf16 predictions cannot be held within
    1e-2 of scale of each other. The check: the port's bf16 prediction is
    within 1e-2 of scale of the float32 prediction beyond the error JAX's
    bf16 prediction has there (scale: max |float32 prediction|). A bf16
    path that computes something else (a PyTorch CPU bf16 convolution at a
    (1, 8) kernel is off by the output's whole scale) misses it by far."""
    jf, spec, jspec, params, consts, x, _ = _case(name)
    model, c = _port(name, spec, params, consts)
    with torch.no_grad():
        pred = _forward(model, c, x, compute_dtype=torch.bfloat16)
    assert pred.dtype == torch.float32
    ref = _jax_forward(jf, params, jspec, consts, x)
    j_bf16 = _jax_forward(jf, params, jspec, consts, x, compute_dtype=jnp.bfloat16)
    scale = np.abs(ref).max()
    jax_err = np.abs(j_bf16 - ref).max()
    port_err = np.abs(pred.numpy() - ref).max()
    assert port_err <= jax_err + 1e-2 * scale, (port_err / scale, jax_err / scale)
    assert all(p.dtype == torch.float32 for p in model.parameters())  # float32 masters


@pytest.mark.parametrize("name", FAMILIES)
def test_three_step_trajectory_matches_jax(name):
    """Same weights, same batches, dropout 0: per-step SmoothL1 + Adam losses
    agree with JAX ``make_train_step(apply_fn=family.apply)``."""
    jf, spec, jspec, params, consts, x, y = _case(name, seed=4, batch=12, dropout_rate=0.0)
    model, c = _port(name, spec, params, consts)  # before JAX donates the params
    idx = np.random.default_rng(4).permutation(12).reshape(3, 4).astype(np.int32)
    lr = 1e-3
    opt = jax_optimizer(lr)
    step = make_train_step(jspec, opt, apply_fn=jf.apply)
    p, s, key = params, opt.init(params), jax.random.PRNGKey(0)
    jax_losses = []
    for b in range(3):
        p, s, key, loss = step(p, s, key, x, y, idx[b], consts)
        jax_losses.append(float(loss))

    optimizer = make_optimizer(model.parameters(), lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(train_step(model, optimizer, xt[i], yt[i], c))
              for i in torch.from_numpy(idx.astype(np.int64))]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
    assert abs(losses[0] - losses[-1]) > 1e-4  # the trajectory moves


def _xavier_bound(shape):
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return (6.0 / ((shape[0] + shape[1]) * receptive)) ** 0.5


@pytest.mark.parametrize("name", FAMILIES)
def test_parameters_and_init_match_jax(name):
    """The port's parameters have the keys and shapes ``params_from_jax``
    gives, and each is drawn inside its JAX bound: xavier by its own fans
    for ndim > 1 (Θ as K separate (C_in, C_out) draws, whose bound a stacked
    (K, C_in, C_out) tensor would shrink by half), U(0, 1) otherwise (biases
    and LayerNorm affines). The JAX leaf obeys the same bound."""
    _, spec, _, params, _, _, _ = _case(name)
    fam = get_family(name)
    model, consts = fam.make_model(spec, _ring(), _ring(), seed=3, device="cpu")
    expected = fam.params_from_jax(params, spec)
    got = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in got.items()} == \
        {n: tuple(v.shape) for n, v in expected.items()}
    for n, p in got.items():
        v, jv = p.detach().numpy(), expected[n].numpy()
        if p.ndim > 1:
            bound = _xavier_bound(p.shape)
            assert np.abs(v).max() <= bound and np.abs(jv).max() <= bound, n
            if p.numel() >= 64:
                assert np.abs(v).max() > 0.5 * bound, n
        else:
            assert v.min() >= 0.0 and v.max() <= 1.0, n
            assert jv.min() >= 0.0 and jv.max() <= 1.0, n
    assert consts["cheb_polys"].shape == (
        (spec.K, 1, 1) if name == "transformer" else (spec.K, N, N))


# ---------------------------------------------------------------------------
# the traps
# ---------------------------------------------------------------------------

def test_stgcn_stops_blocks_when_time_runs_out():
    """T = 12 with nb_block = 4: each block eats 2·(KT−1) = 4 steps, so two
    blocks exist and the head maps C_t·4 features; the model still matches
    JAX."""
    jf, spec, _, params, consts, _, _ = _case("stgcn", nb_block=4)
    model, _ = _port("stgcn", spec, params, consts)
    assert len(model.blocks) == len(params["blocks"]) == 2
    assert model.head.in_features == spec.nb_time_filter * 4
    _check_forward("stgcn", nb_block=4)


def test_astgcn_with_time_strides_2():
    """Block 1's temporal and residual convs stride 2, later blocks' attention
    shapes use T // 2, and the head reads T // 2 steps."""
    _check_forward("astgcn", time_strides=2)
    _check_gradients("astgcn", time_strides=2)


def test_transformer_gelu_is_the_tanh_approximation(monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh approximation. At these widths the
    exact-erf GELU moves the prediction ≈ 2e-4 from JAX's, the tanh one
    ≈ 1e-6, so this case holds the port to 2e-5 (ten times tighter than the
    forward test) and checks that an exact-erf GELU misses it."""
    jf, spec, jspec, params, consts, x, _ = _case("transformer")
    model, c = _port("transformer", spec, params, consts)
    ref = _jax_forward(jf, params, jspec, consts, x)
    with torch.no_grad():
        np.testing.assert_allclose(_forward(model, c, x).numpy(), ref, atol=2e-5, rtol=0)
        exact = transformer.F.gelu
        monkeypatch.setattr(transformer.F, "gelu", lambda t, approximate="none": exact(t))
        erf = _forward(model, c, x).numpy()
    assert np.abs(erf - ref).max() > 5 * 2e-5


def test_get_family_matches_jax():
    """Names resolve case-insensitively; an unknown name raises JAX's text."""
    for name in FAMILIES + ["dstagnn"]:
        assert get_family(name.upper()).__name__.endswith(f".{name}")
    with pytest.raises(ValueError) as ours:
        get_family("transformer9000")
    with pytest.raises(ValueError) as theirs:
        jax_family("transformer9000")
    assert str(ours.value) == str(theirs.value)
