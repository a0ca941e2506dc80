"""The port's cheb_sat module (ops/cuda/cheb_sat.py) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA kernel
itself is held against that version on the card (the ``cuda`` case below,
skipped here, and chip_smoke.py). Forward atol 2e-4 and gradient atol 5e-3,
the precedents of tests/test_pallas_cheb.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.ops.pallas.cheb_sat import (
    cheb_conv_with_sat_pallas as jax_conv_pallas,
    fused_sat_aggregate as jax_fused,
)
from dstagnn_drought_tpu_torch.ops.cheb import cheb_conv_with_sat
from dstagnn_drought_tpu_torch.ops.cuda import cheb_sat

torch.set_num_threads(1)


def _inputs(rng, B=2, K=3, N=19, C=4, T=6):
    scores = rng.normal(size=(B, K, N, N)).astype(np.float32)
    adj_pa = (rng.random((N, N)) < 0.3).astype(np.float32)
    masks = rng.normal(size=(K, N, N)).astype(np.float32)
    cheb = rng.normal(size=(K, N, N)).astype(np.float32)
    thetas = rng.normal(size=(K, C, 8)).astype(np.float32) * 0.1
    x = rng.normal(size=(B, N, C, T)).astype(np.float32)
    return scores, adj_pa, masks, cheb, thetas, x


T_ = torch.from_numpy


@pytest.mark.parametrize("B,K,N,C,T", [
    (2, 3, 19, 4, 6),
    # the unaligned shapes of tests/test_pallas_cheb.py::test_unaligned_shapes
    (1, 2, 7, 1, 12), (1, 2, 130, 3, 5), (1, 2, 33, 2, 9),
])
def test_aggregate_matches_pallas_interpret(rng, B, K, N, C, T):
    scores, adj_pa, masks, cheb, _, x = _inputs(rng, B, K, N, C, T)
    bias = adj_pa[None] * masks
    xm = x.reshape(B, N, C * T)
    want = np.asarray(jax_fused(jnp.asarray(scores), jnp.asarray(bias),
                                jnp.asarray(cheb), jnp.asarray(xm), interpret=True))
    plain = cheb_sat.sat_aggregate_plain(T_(scores), T_(bias), T_(cheb), T_(xm))
    wrapped = cheb_sat.fused_sat_aggregate(T_(scores), T_(bias), T_(cheb), T_(xm))
    fn = cheb_sat.SatAggregate.apply(T_(scores), T_(bias), T_(cheb), T_(xm))
    for got in (plain, wrapped, fn):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_cpu_path_counts_no_launch(rng):
    scores, adj_pa, masks, cheb, _, x = _inputs(rng)
    before = cheb_sat.launches
    cheb_sat.fused_sat_aggregate(T_(scores), T_(adj_pa[None] * masks), T_(cheb),
                                 T_(x.reshape(2, 19, 24)))
    assert cheb_sat.launches == before


def test_kernel_refuses_what_it_does_not_take(rng):
    scores, adj_pa, masks, cheb, _, x = _inputs(rng)
    args = [T_(scores), T_(adj_pa[None] * masks), T_(cheb), T_(x.reshape(2, 19, 24))]
    # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="CUDA"):
        cheb_sat.sat_aggregate_cuda(*args)
    with pytest.raises(TypeError, match="float32"):
        cheb_sat.sat_aggregate_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="x must be"):
        cheb_sat.sat_aggregate_cuda(*args[:3], args[3][:, :5])


def test_conv_dropin_and_grads_match_jax(rng):
    scores, adj_pa, masks, cheb, thetas, x = _inputs(rng, B=1, K=2, N=11, C=2, T=5)

    def jax_loss(s, m, xx):
        out = jax_conv_pallas(xx, s, jnp.asarray(adj_pa), cheb_polys=jnp.asarray(cheb),
                              masks=m, thetas=jnp.asarray(thetas))
        return jnp.sum(out * out), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(scores), jnp.asarray(masks), jnp.asarray(x))

    for conv in (cheb_sat.cheb_conv_with_sat_pallas, cheb_conv_with_sat):
        leaves = [T_(a).clone().requires_grad_(True) for a in (scores, masks, x)]
        out = conv(leaves[2], leaves[0], T_(adj_pa), cheb_polys=T_(cheb),
                   masks=leaves[1], thetas=T_(thetas))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                                   atol=2e-4, rtol=2e-4)
        (out * out).sum().backward()
        for leaf, jg, name in zip(leaves, j_grads, ("scores", "masks", "x")):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                       atol=5e-3, rtol=5e-3, err_msg=name)


def test_function_gradcheck_float64(rng):
    """The hand-written backward against finite differences (float64)."""
    B, K, N, M = 1, 2, 5, 3
    g = lambda *s: torch.from_numpy(rng.normal(size=s)).double()
    scores = g(B, K, N, N).requires_grad_(True)
    bias = g(K, N, N).requires_grad_(True)
    cheb = g(K, N, N)
    x = g(B, N, M).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda s, b, xx: cheb_sat.SatAggregate.apply(s, b, cheb, xx), (scores, bias, x))


def test_bf16_inputs_return_input_dtype(rng):
    scores, adj_pa, masks, cheb, thetas, x = _inputs(rng)
    out = cheb_sat.cheb_conv_with_sat_pallas(
        T_(x).bfloat16(), T_(scores).bfloat16(), T_(adj_pa).bfloat16(),
        cheb_polys=T_(cheb).bfloat16(), masks=T_(masks).bfloat16(),
        thetas=T_(thetas).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (2, 19, 8, 6)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, K, N, C, T in ((2, 3, 19, 4, 6), (1, 2, 7, 1, 12), (1, 2, 130, 3, 5)):
        scores, adj_pa, masks, cheb, _, x = _inputs(rng, B, K, N, C, T)
        args = [T_(a).cuda().contiguous() for a in
                (scores, adj_pa[None] * masks, cheb, x.reshape(B, N, C * T))]
        before = cheb_sat.launches
        got = cheb_sat.fused_sat_aggregate(*args)
        torch.cuda.synchronize()
        assert cheb_sat.launches == before + 1
        want = cheb_sat.sat_aggregate_plain(*args)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
