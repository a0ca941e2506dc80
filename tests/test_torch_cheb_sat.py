"""The port's cheb_sat module (ops/cuda/cheb_sat.py) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA kernel
itself is held against that version on the card (the ``cuda`` case below,
skipped here, and chip_smoke.py). Here the kernel's launch plan is pinned
and its hi/lo arithmetic emulated in plain torch. Forward atol 2e-4 and
gradient atol 5e-3, the precedents of tests/test_pallas_cheb.py; bf16
outputs 1e-2 of their scale.
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
    with pytest.raises(TypeError, match="float32"):
        cheb_sat.sat_aggregate_cuda(args[0].bfloat16(), *args[1:])
    # a bf16 x passes the dtype check, and a CPU tensor still never
    # reaches the kernel
    with pytest.raises(ValueError, match="CUDA"):
        cheb_sat.sat_aggregate_cuda(*args[:3], args[3].bfloat16())
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


# sat_plan at the main path's shapes (x as the model hands it over: float32
# at PEMS08, bf16 at GAMBIA) and the ragged shapes of chip_smoke.py's
# CHEB_SAT_SHAPES: (B, K, N, M, x_is_bf16) -> the plan
SAT_PLANS = [
    ((64, 3, 170, 12, False), dict(tj=64, tm=16, warps=8, stages=4, x_planes=True,
                                   products=3, smem=49152, scratch=23936000,
                                   grid=(1, 3, 192))),
    ((64, 3, 170, 384, False), dict(tj=64, tm=128, warps=8, stages=4, x_planes=True,
                                    products=3, smem=106496, scratch=39951360,
                                    grid=(3, 3, 192))),
    ((4, 2, 2139, 576, True), dict(tj=128, tm=128, warps=8, stages=4, x_planes=False,
                                   products=2, smem=104448, scratch=146889728,
                                   grid=(5, 17, 8))),
    ((4, 2, 2139, 4608, True), dict(tj=128, tm=256, warps=16, stages=4,
                                    x_planes=False, products=2, smem=137216,
                                    scratch=146889728, grid=(18, 17, 8))),
    ((1, 2, 7, 12, False), dict(tj=64, tm=16, warps=8, stages=4, x_planes=True,
                                products=3, smem=49152, scratch=1536, grid=(1, 1, 2))),
    ((1, 2, 130, 15, False), dict(tj=64, tm=16, warps=8, stages=4, x_planes=True,
                                  products=3, smem=49152, scratch=152576, grid=(1, 3, 2))),
    ((1, 2, 33, 18, False), dict(tj=64, tm=32, warps=8, stages=4, x_planes=True,
                                 products=3, smem=57344, scratch=15104, grid=(1, 1, 2))),
]


@pytest.mark.parametrize("shape,want", SAT_PLANS, ids=[str(s) for s, _ in SAT_PLANS])
def test_sat_plan_pins(shape, want):
    plan = cheb_sat.sat_plan(*shape)
    assert plan == want
    # two blocks share an SM at 8 warps, one holds it at 16; the bytes are
    # the formula's
    assert plan["smem"] <= {8: 115712, 16: 232448}[plan["warps"]]
    xs = 0 if shape[-1] else 1
    assert plan["smem"] == cheb_sat.sat_smem_bytes(plan["tj"], plan["tm"], xs, plan["stages"])


def test_sat_plan_float32_x_at_gambia_takes_three_products():
    """The other x dtype at GAMBIA block 2: x's hi and lo planes (scratch
    grows by B·N·pad8(M)·4 bytes), a third product, the same tiles."""
    bf, f32 = (cheb_sat.sat_plan(4, 2, 2139, 4608, b) for b in (True, False))
    assert (f32["products"], f32["x_planes"], f32["smem"]) == (3, True, 204800)
    assert (f32["tj"], f32["tm"], f32["stages"]) == (bf["tj"], bf["tm"], bf["stages"])
    assert f32["scratch"] - bf["scratch"] == 4 * 4 * 2139 * 4608


def _split(v):
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


@pytest.mark.parametrize("N,M,x_bf16", [(170, 64, False), (300, 48, True), (33, 18, False)])
def test_split_emulation_meets_float32(rng, N, M, x_bf16):
    """The kernel's arithmetic in plain torch: Aᵀ·x as the three bf16
    products A_hiᵀx_hi + A_hiᵀx_lo + A_loᵀx_hi (bf16 products are exact in
    float32; the sums float32) is within 1e-4 of scale of the float64
    product, where a no-split control (A and x rounded to bf16) is not."""
    s = torch.from_numpy(rng.normal(size=(N, N)))
    a = (torch.from_numpy(rng.normal(size=(N, N))) * torch.softmax(s, dim=0)).float()
    x = torch.from_numpy(rng.normal(size=(N, M))).float()
    if x_bf16:
        x = x.bfloat16().float()
    want = a.double().T @ x.double()
    a_hi, a_lo = _split(a)
    x_hi, x_lo = _split(x)
    split = a_hi.T @ x_hi + a_hi.T @ x_lo + a_lo.T @ x_hi
    control = a.bfloat16().float().T @ x.bfloat16().float()
    scale = float(want.abs().max())
    rel = lambda got: float((got.double() - want).abs().max()) / scale
    assert rel(split) <= 1e-4 < rel(control)
    if x_bf16:
        assert float(x_lo.abs().max()) == 0.0  # the product the plan drops is zero


def test_bf16_x_through_function_keeps_its_value(rng):
    """A bf16 x goes into SatAggregate as it is: the output equals the one
    from its float32 copy, and dx comes back in bf16, the float32 dx
    rounded."""
    scores, adj_pa, masks, cheb, _, x = _inputs(rng)
    bias = T_(adj_pa[None] * masks)
    xb = T_(x.reshape(2, 19, 24)).bfloat16()
    outs, grads = [], []
    for xx in (xb.clone(), xb.float()):
        xx.requires_grad_(True)
        out = cheb_sat.SatAggregate.apply(T_(scores), bias, T_(cheb), xx)
        (out * out).sum().backward()
        outs.append(out)
        grads.append(xx.grad)
    assert torch.equal(outs[0], outs[1])
    assert grads[0].dtype == torch.bfloat16
    assert torch.equal(grads[0], grads[1].bfloat16())


def test_bf16_conv_matches_jax_by_value(rng):
    """bf16 inputs through the drop-in against the JAX drop-in (interpret
    mode), by value within 1e-2 of the output's scale (both aggregate in
    float32; the bf16 rounding of the output may differ by an ulp)."""
    scores, adj_pa, masks, cheb, thetas, x = _inputs(rng)
    bf = lambda a: T_(a).bfloat16()
    got = cheb_sat.cheb_conv_with_sat_pallas(
        bf(x), bf(scores), bf(adj_pa), cheb_polys=bf(cheb), masks=bf(masks),
        thetas=bf(thetas))
    jb = lambda a: jnp.asarray(a, dtype=jnp.bfloat16)
    want = np.asarray(jax_conv_pallas(
        jb(x), jb(scores), jb(adj_pa), cheb_polys=jb(cheb), masks=jb(masks),
        thetas=jb(thetas)).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.float().numpy() - want).max()) <= 1e-2 * scale


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
    for B, K, N, C, T in ((2, 3, 19, 4, 6), (1, 2, 7, 1, 12), (1, 2, 130, 3, 5),
                          (1, 2, 300, 4, 64)):
        scores, adj_pa, masks, cheb, _, x = _inputs(rng, B, K, N, C, T)
        args = [T_(a).cuda().contiguous() for a in
                (scores, adj_pa[None] * masks, cheb, x.reshape(B, N, C * T))]
        for xx in (args[3], args[3].bfloat16()):  # float32 x (three products), bf16 (two)
            before = cheb_sat.launches
            got = cheb_sat.fused_sat_aggregate(*args[:3], xx)
            torch.cuda.synchronize()
            assert cheb_sat.launches == before + 1
            want = cheb_sat.sat_aggregate_plain(*args[:3], xx)
            torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
