"""The port's fused GTU tail (ops/cuda/gtu_fused.py) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA kernels
are held against that version on the card (the ``cuda`` case below, skipped
here, and chip_smoke.py). Shapes and weight layout are those of
tests/test_gtu_fused.py. Tolerances: forward atol 2e-4; gradients 1e-4 of
each gradient's scale (both sides sum the same float32 products in another
order); in bfloat16 1e-2 of the output's scale (about 2.5 bf16 ulps: both
sides round the output once, the gradients at the same points).
"""
import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card but no JAX runs only the cuda cases
    import jax
    import jax.numpy as jnp

    from dstagnn_drought_tpu.ops.pallas.gtu_fused import gtu_fcmy as jax_gtu_fcmy
    from dstagnn_drought_tpu.ops.pallas.gtu_fused import supported as jax_supported
except ImportError:
    jax = jnp = jax_gtu_fcmy = jax_supported = None
from dstagnn_drought_tpu_torch.ops.cuda import gtu_fused

torch.set_num_threads(1)

NAMES = ("x", "w3", "b3", "w5", "b5", "w7", "b7", "wfc", "bfc")


def _arrays(seed, B, N, C, T):
    """x, the three convs' OIHW weights and biases, and fcmy (3T-12, T)."""
    rng = np.random.default_rng(seed)
    a = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    out = {"x": a(B, N, C, T)}
    for k in gtu_fused.KS:
        out[f"w{k}"], out[f"b{k}"] = a(2 * C, C, 1, k), a(2 * C)
    out["wfc"], out["bfc"] = a(3 * T - 12, T), a(T)
    out["wgt"] = rng.normal(size=(B, N, C, T)).astype(np.float32)
    return out


def _jax(a, dtype=jnp.float32):
    args = [jnp.asarray(a[n]).astype(dtype) for n in NAMES]
    wgt = jnp.asarray(a["wgt"])

    def loss(*args):
        out = jax_gtu_fcmy(True, *args)
        return jnp.sum(wgt * out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(9)), has_aux=True)(*args)
    return out, grads


def _port(a, dtype=torch.float32):
    t = [torch.from_numpy(a[n]).to(dtype).requires_grad_(True) for n in NAMES]
    out = gtu_fused.gtu_fcmy(*t)
    (torch.from_numpy(a["wgt"]) * out.float() ** 2).sum().backward()
    return out, [p.grad for p in t]


@pytest.mark.parametrize("shape", [(2, 10, 16, 48), (1, 3, 32, 64)])
def test_gtu_fcmy_matches_jax(shape):
    a = _arrays(0, *shape)
    j_out, j_grads = _jax(a)
    out, grads = _port(a)
    B, N, C, T = shape
    assert out.shape == (B, N, C, T)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=2e-4)
    for name, g, jg in zip(NAMES, grads, j_grads):
        jg = np.asarray(jg)
        assert g.shape == jg.shape, name
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 5, 16, 48), (1, 2, 48, 48)])
def test_bfloat16_forward_matches_jax(shape):
    """At C = 16 and at C = 48 (three channel groups of 16 pairs on the
    card)."""
    a = _arrays(3, *shape)
    j_out, _ = _jax(a, jnp.bfloat16)
    t = [torch.from_numpy(a[n]).bfloat16() for n in NAMES]
    out = gtu_fused.gtu_fcmy(*t)
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_out.astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0, atol=1e-2 * scale)


def test_bfloat16_gradients_match_jax():
    """The plain version's bf16 backward rounds th, sg, dP and dQ where the
    TPU kernel does: every gradient within 2e-2 of its scale of JAX's."""
    a = _arrays(4, 1, 4, 16, 48)
    _, j_grads = _jax(a, jnp.bfloat16)
    _, grads = _port(a, torch.bfloat16)
    for name, g, jg in zip(NAMES, grads, j_grads):
        assert g.dtype == torch.bfloat16, name
        jg = np.asarray(jg.astype(jnp.float32))
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(g.float().numpy() / scale, jg / scale, rtol=0, atol=2e-2,
                                   err_msg=name)


def test_supported_gate():
    cases = [(32, 144, 1), (32, 144, 2), (32, 12, 1), (5, 144, 1), (32, 50, 1),
             (16, 48, 1), (16, 32, 1), (48, 96, 1)]
    assert gtu_fused.supported(32, 144, 1)
    assert not gtu_fused.supported(32, 144, 2)   # strides
    assert not gtu_fused.supported(32, 12, 1)    # short T keeps the conv path
    assert not gtu_fused.supported(5, 144, 1)    # C alignment
    assert not gtu_fused.supported(32, 50, 1)    # T alignment
    for c in cases:
        assert gtu_fused.supported(*c) == jax_supported(*c), c


def test_pack_unpack_round_trip():
    a = _arrays(5, 1, 2, 16, 48)
    ws = [torch.from_numpy(a[n]) for n in NAMES[1:7]]
    wp, bp = gtu_fused.pack(*ws, torch.float32)
    assert wp.shape == (15, 32, 16) and bp.shape == (3, 32)
    assert wp.dtype == bp.dtype == torch.float32 and wp.is_contiguous()
    # tap kk of conv 5 is row 3 + kk, holding w5[:, :, 0, kk]
    assert torch.equal(wp[3 + 2], ws[2][:, :, 0, 2])
    dws, dbs = gtu_fused.unpack_grads(wp, bp)
    for (w, b), dw, db in zip(zip(ws[0::2], ws[1::2]), dws, dbs):
        assert torch.equal(dw, w) and torch.equal(db, b)
    # the weights are rounded to the compute dtype, the biases stay float32
    wp16, bp16 = gtu_fused.pack(*ws, torch.bfloat16)
    assert torch.equal(wp16, wp.bfloat16().float()) and torch.equal(bp16, bp)


def _kernel_args(dtype=torch.float32):
    a = _arrays(6, 2, 3, 16, 48)
    x = torch.from_numpy(a["x"]).to(dtype)
    wp, bp = gtu_fused.pack(*[torch.from_numpy(a[n]) for n in NAMES[1:7]], dtype)
    g = torch.zeros((2, 3, 3 * 48 - 12, 16), dtype=dtype)
    return x, wp, bp, g


def test_kernels_refuse_what_they_do_not_take():
    x, wp, bp, g = _kernel_args()
    with pytest.raises(ValueError, match="CUDA"):
        gtu_fused.gtu_forward_cuda(x, wp, bp)
    with pytest.raises(ValueError, match="CUDA"):
        gtu_fused.gtu_backward_cuda(x, g, wp, bp)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gtu_fused.gtu_forward_cuda(x.double(), wp, bp)
    with pytest.raises(TypeError, match="float32 wp"):
        gtu_fused.gtu_forward_cuda(x, wp.bfloat16(), bp)
    with pytest.raises(TypeError, match="g must have"):
        gtu_fused.gtu_backward_cuda(x, g.bfloat16(), wp, bp)
    with pytest.raises(ValueError, match="contiguous"):
        gtu_fused.gtu_forward_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), wp, bp)
    with pytest.raises(ValueError, match="wp must be"):
        gtu_fused.gtu_forward_cuda(x, wp[:14], bp)
    with pytest.raises(ValueError, match="bp must be"):
        gtu_fused.gtu_forward_cuda(x, wp, bp[:, :8])
    with pytest.raises(ValueError, match="x must be"):
        gtu_fused.gtu_forward_cuda(x[0], wp, bp)
    with pytest.raises(ValueError, match="T must be"):
        gtu_fused.gtu_forward_cuda(x[..., :6].contiguous(), wp, bp)
    # a C outside JAX's gate is refused, naming it
    assert "C=40" in gtu_fused.limit_error(40, 144, torch.bfloat16, False)


@pytest.mark.parametrize("C, T, dtype, backward, fits", [
    (32, 144, torch.float32, True, True), (32, 144, torch.bfloat16, True, True),
    (48, 144, torch.float32, True, True), (48, 144, torch.bfloat16, True, True),
    (48, 144, torch.float32, False, True), (32, 240, torch.float32, True, True),
    (32, 240, torch.bfloat16, True, True), (64, 48, torch.bfloat16, True, True),
    (48, 608, torch.bfloat16, False, True), (48, 624, torch.bfloat16, False, True),
    (32, 1120, torch.bfloat16, False, True), (32, 1136, torch.bfloat16, False, True),
    (16, 2128, torch.bfloat16, False, True), (16, 2144, torch.bfloat16, False, True),
    (64, 48, torch.bfloat16, False, True), (80, 48, torch.bfloat16, False, True),
    (40, 144, torch.bfloat16, True, False), (32, 40, torch.float32, False, False),
])
def test_limit_error_is_the_card_gate(C, T, dtype, backward, fits):
    """limit_error is JAX's gate and nothing more: the shapes that used to
    exceed a block's 227 KiB or to have no bf16 instantiation (C = 48 in
    float32, C = 64 and 80, T past 240, 608, 1120, 2128) run (the card's
    smoke script holds the kernels' own shared memory within 227 KiB); a
    C or T outside JAX's gate is refused, naming both."""
    why = gtu_fused.limit_error(C, T, dtype, backward)
    assert (why is None) == fits, why
    if why is not None:
        assert f"C={C}" in why and f"T={T}" in why


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_limit_error_admits_every_supported_shape(dtype):
    """Every C in {16, 32, 48, 64, 128} at every T in {48, 144, 288, 576,
    1024} runs in both directions."""
    for C in (16, 32, 48, 64, 128):
        for T in (48, 144, 288, 576, 1024):
            for backward in (False, True):
                assert gtu_fused.limit_error(C, T, dtype, backward) is None


def test_cpu_path_counts_no_launch():
    before = (gtu_fused.fwd_launches, gtu_fused.bwd_launches)
    _port(_arrays(7, 1, 2, 16, 48))
    assert (gtu_fused.fwd_launches, gtu_fused.bwd_launches) == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _arrays(8, 2, 5, 16, 48)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        leaves = [[torch.from_numpy(a[n]).to(dtype).cuda().requires_grad_(True)
                   for n in NAMES[:7]] for _ in range(2)]
        before = (gtu_fused.fwd_launches, gtu_fused.bwd_launches)
        out = gtu_fused.gtu_cat(*leaves[0])
        out_p = gtu_fused.gtu_cat_plain(*leaves[1])
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(out)
        (out.float() * cot.float()).sum().backward()
        (out_p.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        assert (gtu_fused.fwd_launches, gtu_fused.bwd_launches) == (before[0] + 1,
                                                                     before[1] + 1)
        torch.testing.assert_close(out.float(), out_p.float(), atol=tol, rtol=0)
        for k, p in zip(leaves[0], leaves[1]):
            scale = max(1.0, float(p.grad.float().abs().max()))
            torch.testing.assert_close(k.grad.float(), p.grad.float(), atol=tol * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 16, 80), (2, 9, 32, 144), (1, 5, 48, 144)])
def test_bf16_tensor_core_backward_on_card(shape):
    """The bfloat16 backward (WMMA) against autograd through the plain
    version, at a shape where every T_out (78, 76, 74) is ragged against 16,
    at GAMBIA's C = 32, T = 144 with a small B·N, and at C = 48: dx and every
    weight gradient within 1e-2 of scale, dW and db equal bit for bit over
    two launches, one launch counted for each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _arrays(9, *shape)
    dtype = torch.bfloat16
    ins = [torch.from_numpy(a[n]).to(dtype).cuda() for n in NAMES[:7]]
    B, N, C, T = shape
    g = torch.randn((B, N, gtu_fused.out_len(T), C),
                    generator=torch.Generator().manual_seed(1)).to(dtype).cuda()
    wp, bp = gtu_fused.pack(*ins[1:], dtype)
    before = gtu_fused.bwd_launches
    first = gtu_fused.gtu_backward_cuda(ins[0], g, wp, bp)
    again = gtu_fused.gtu_backward_cuda(ins[0], g, wp, bp)
    torch.cuda.synchronize()
    assert gtu_fused.bwd_launches == before + 2
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    leaves = [t.clone().requires_grad_(True) for t in ins]
    out = gtu_fused.gtu_cat_plain(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    dws, dbs = gtu_fused.unpack_grads(first[1], first[2])
    got = [first[0], dws[0], dbs[0], dws[1], dbs[1], dws[2], dbs[2]]
    for name, k, p in zip(NAMES, got, grads):
        scale = max(1.0, float(p.float().abs().max()))
        torch.testing.assert_close(k.float(), p.float(), atol=1e-2 * scale, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 16, 80), (2, 9, 32, 144), (1, 5, 48, 144)])
def test_bf16_tensor_core_forward_on_card(shape):
    """The bfloat16 forward (WMMA) against the plain version at the shapes
    of the backward's test: the output within 1e-2 of scale, from x as given
    and from x as a view at an odd element offset (the wrapper copies it to
    16-byte alignment), one launch counted for each call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _arrays(10, *shape)
    dtype = torch.bfloat16
    ins = [torch.from_numpy(a[n]).to(dtype).cuda() for n in NAMES[:7]]
    x = ins[0]
    odd = torch.empty(x.numel() + 1, dtype=dtype, device=x.device)[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    wp, bp = gtu_fused.pack(*ins[1:], dtype)
    want = gtu_fused.gtu_cat_plain(*ins).float()
    scale = max(1.0, float(want.abs().max()))
    before = gtu_fused.fwd_launches
    for xin in (x, odd):
        out = gtu_fused.gtu_forward_cuda(xin, wp, bp)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == want.shape
        torch.testing.assert_close(out.float(), want, atol=1e-2 * scale, rtol=0)
    assert gtu_fused.fwd_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 64, 288), (1, 2, 128, 144), (1, 3, 80, 96),
                                   (2, 3, 32, 576)])
def test_tiled_shapes_on_card(shape):
    """The tiled kernels at shapes the card refused before: channel groups
    and chunks of C (64, 80, 128), time tiles with their halo (T = 288,
    576); float32 and bf16 against the plain version (1e-4 and 1e-2 of
    scale), dW and db bit for bit over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = _arrays(11, *shape)
    B, N, C, T = shape
    cot = torch.randn((B, N, gtu_fused.out_len(T), C), generator=torch.Generator().manual_seed(2))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        ins = [torch.from_numpy(a[n]).to(dtype).cuda() for n in NAMES[:7]]
        g = cot.to(dtype).cuda()
        outs = []
        for fn in (gtu_fused.gtu_cat, gtu_fused.gtu_cat_plain):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            out = fn(*leaves)
            outs.append([out] + list(torch.autograd.grad(out, leaves, g)))
        for k, p in zip(*outs):
            scale = max(1.0, float(p.float().abs().max()))
            torch.testing.assert_close(k.float(), p.float(), atol=tol * scale, rtol=0)
        wp, bp = gtu_fused.pack(*ins[1:], dtype)
        first, again = (gtu_fused.gtu_backward_cuda(ins[0], g, wp, bp) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
