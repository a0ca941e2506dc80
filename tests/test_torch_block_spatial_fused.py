"""The port's fused spatial middle (ops/cuda/block_spatial_fused.py) against
the JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA kernels
are held against that version on the card (the ``cuda`` case below, skipped
here, and chip_smoke.py). Tolerances are the JAX fused-kernel tests'
(tests/test_block_spatial_fused.py): forward 1e-4, gradients 3e-3; in
bfloat16 2e-2 of the output's scale (the matmul operands are rounded to
bf16 at every cast of the TPU kernel, and a value one side rounds up may
round down on the other: a few bf16 ulps of 2^-8).
"""
import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card but no JAX runs only the cuda case
    import jax
    import jax.numpy as jnp

    from dstagnn_drought_tpu.ops.pallas import block_spatial_fused as jbsf
except ImportError:
    jax = jnp = jbsf = None
from dstagnn_drought_tpu_torch.models.dstagnn import DSTAGNN, ModelSpec
from dstagnn_drought_tpu_torch.ops.attention import spatial_attention_scores
from dstagnn_drought_tpu_torch.ops.cheb import cheb_conv_with_sat
from dstagnn_drought_tpu_torch.ops.cuda import block_spatial_fused as bsf
from dstagnn_drought_tpu_torch.ops.nn import dropout, layer_norm

torch.set_num_threads(1)

B, T, N, K, DK, D, CO = 3, 6, 18, 3, 8, 24, 5
PARAMS = ("pre_w", "pre_b", "pos", "gs", "bs", "wq", "wk", "masks", "thetas")


def _tensors(F, C, seed=0, k=K):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    a = dict(tat=mk(B, F, T, N), x=mk(B, N, C, T), pre_w=mk(D, T, 1, F), pre_b=mk(D),
             pos=mk(N, D), gs=np.full(D, 1.05, np.float32), bs=np.full(D, 0.02, np.float32),
             wq=mk(D, k * DK), wk=mk(D, k * DK), masks=mk(k, N, N), thetas=mk(k, C, CO))
    adj = (rng.random((N, N)) < 0.3).astype(np.float32)
    return a, adj, mk(k, N, N)


def _kw(a, adj, cheb, k=K):
    return dict(pre_w=a["pre_w"], pre_b=a["pre_b"], pos=a["pos"], ln_scale=a["gs"],
                ln_bias=a["bs"], wq=a["wq"], wk=a["wk"], adj_pa=adj, masks=a["masks"],
                cheb_polys=cheb, thetas=a["thetas"], K=k, d_k=DK)


def _loss(out, lib):
    return (lib.sin(out) ** 2).sum()


@pytest.mark.parametrize("F,C", [(1, 1), (4, 4)], ids=["F1", "F4"])
def test_forward_and_grads_match_jax(F, C):
    """F = 1 is a first block (F·T = T, one input channel); F > 1 a later one."""
    a, adj, cheb = _tensors(F, C)

    def jloss(t):
        out = jbsf.fused_spatial_middle(t["tat"], t["x"], **_kw(t, adj, cheb))
        return _loss(out, jnp), out

    (_, j_out), j_g = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in a.items()})
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in a.items()}
    out = bsf.fused_spatial_middle(t["tat"], t["x"], **_kw(t, torch.from_numpy(adj),
                                                          torch.from_numpy(cheb)))
    assert out.shape == (B, N, CO, T)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-4, rtol=1e-4)
    _loss(out, torch).backward()
    for name in ("tat", "x", *PARAMS):
        np.testing.assert_allclose(t[name].grad.numpy(), np.asarray(j_g[name]), atol=3e-3,
                                   rtol=3e-3, err_msg=name)


def test_bfloat16_forward_matches_jax():
    a, adj, cheb = _tensors(4, 4, seed=1)
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in a.items()}
    j_out = jbsf.fused_spatial_middle(
        bf["tat"], bf["x"], **_kw(bf, jnp.asarray(adj, jnp.bfloat16),
                                  jnp.asarray(cheb, jnp.bfloat16)))
    t = {k: torch.from_numpy(v).bfloat16() for k, v in a.items()}
    out = bsf.fused_spatial_middle(t["tat"], t["x"], **_kw(
        t, torch.from_numpy(adj).bfloat16(), torch.from_numpy(cheb).bfloat16()))
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_out.astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2 * scale, rtol=2e-2)


def test_bfloat16_grads_match_jax():
    """The bf16 backward: the JAX ``_vjp_bwd`` (Pallas, interpret mode) and
    the port's plain version (the yardstick of the bf16 backward kernel on
    the card) on the same bf16 inputs and cotangent, K = 2. Within 1e-2 of
    each gradient's scale, with the cotangent zeroed where either side's
    output lies within the forward tolerance of the ReLU kink (one flipped
    mask element changes a whole batch row's gradients)."""
    k2, F, C, tol = 2, 4, 4, 1e-2
    a, adj, cheb = _tensors(F, C, seed=3, k=k2)
    cot = np.random.default_rng(7).normal(size=(B, N, CO, T)).astype(np.float32)
    bf = {name: jnp.asarray(v).astype(jnp.bfloat16) for name, v in a.items()}
    adj_j, cheb_j = jnp.asarray(adj, jnp.bfloat16), jnp.asarray(cheb, jnp.bfloat16)
    j_out, j_vjp = jax.vjp(
        lambda t: jbsf.fused_spatial_middle(t["tat"], t["x"], **_kw(t, adj_j, cheb_j, k2)), bf)
    t = {name: torch.from_numpy(v).bfloat16().requires_grad_(True) for name, v in a.items()}
    out = bsf.fused_spatial_middle(t["tat"], t["x"], **_kw(
        t, torch.from_numpy(adj).bfloat16(), torch.from_numpy(cheb).bfloat16(), k2))
    outs = [np.asarray(j_out.astype(jnp.float32)), out.detach().float().numpy()]
    scale = max(1.0, float(np.abs(outs[0]).max()))
    near = np.zeros(cot.shape, dtype=bool)
    for o in outs:
        near |= (o > 0) & (o <= tol * scale)
    assert near.mean() < 0.2  # the comparison still covers most elements
    cot[near] = 0.0
    (j_g,) = j_vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    out.backward(torch.from_numpy(cot).bfloat16())
    for name in ("tat", "x", *PARAMS):
        got, want = t[name].grad.float().numpy(), np.asarray(j_g[name].astype(jnp.float32))
        g_scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=1e-2 * g_scale, rtol=0, err_msg=name)


def _core_operands(a, adj, cheb, F, C):
    """The kernel-level operands both packages' cores take."""
    pw = a["pre_w"][:, :, 0, :].transpose(2, 1, 0).reshape(F * T, D)
    tat = a["tat"].reshape(B, F * T, N).transpose(0, 2, 1).copy()
    return dict(tat=tat, xm=a["x"].reshape(B, N, C * T), pw=pw, pb=a["pre_b"], pos=a["pos"],
                gs=a["gs"], bs=a["bs"], wqk=np.concatenate([a["wq"], a["wk"]], axis=1),
                bias=adj[None] * a["masks"], cheb=cheb)


def test_dropout_mask_matches_jax_core():
    """One numpy 0/1 mask into the JAX ``_core`` and the port's core."""
    F = C = 4
    a, adj, cheb = _tensors(F, C, seed=2)
    ops = _core_operands(a, adj, cheb, F, C)
    keep = 0.75
    dmask = (np.random.default_rng(9).random((B, N, D)) < keep).astype(np.float32)
    wth = np.einsum("kco,ts->kctos", a["thetas"], np.eye(T, dtype=np.float32)).reshape(
        K, C * T, CO * T)
    order = ("tat", "xm", "pw", "pb", "pos", "gs", "bs", "wqk", "bias", "cheb")
    j = [jnp.asarray(ops[k]) for k in order]
    want = jbsf._core(j[0], j[1], jnp.asarray(dmask), *j[2:], jnp.asarray(wth), K, DK, keep,
                      True)
    tt = {k: torch.from_numpy(np.ascontiguousarray(ops[k])) for k in order}
    got = bsf.spatial_middle(tt["tat"], tt["xm"], torch.from_numpy(dmask),
                             *[tt[k] for k in order[2:]], torch.from_numpy(a["thetas"]),
                             K=K, d_k=DK, keep=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the mask changes the result
    ones = bsf.spatial_middle(tt["tat"], tt["xm"], None, *[tt[k] for k in order[2:]],
                              torch.from_numpy(a["thetas"]), K=K, d_k=DK, keep=1.0)
    assert float((got - ones).abs().max()) > 1e-3


def test_fused_and_unfused_draw_the_same_dropout_bits():
    """Training mode, one generator seed: the fused middle and the port's
    unfused composition (pre_conv, LayerNorm, ops.nn.dropout, spatial
    scores, Chebyshev conv) give the same result and leave the generator
    in the same state."""
    F = C = 4
    a, adj, cheb = _tensors(F, C, seed=4)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    adj_t, cheb_t = torch.from_numpy(adj), torch.from_numpy(cheb)
    rate = 0.3
    g_fused, g_plain = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    fused = bsf.fused_spatial_middle(t["tat"], t["x"], **_kw(t, adj_t, cheb_t),
                                     dropout_rate=rate, generator=g_fused)
    x_tat = torch.einsum("bftn,dtf->bnd", t["tat"], t["pre_w"][:, :, 0, :]) + t["pre_b"]
    sem = layer_norm(x_tat + t["pos"][None], t["gs"], t["bs"])
    sem = dropout(sem, rate, g_plain, deterministic=False)
    scores = spatial_attention_scores(sem, wq=t["wq"], wk=t["wk"], n_heads=K, d_k=DK)
    plain = cheb_conv_with_sat(t["x"], scores, adj_t, cheb_polys=cheb_t, masks=t["masks"],
                               thetas=t["thetas"])
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(g_fused.get_state(), g_plain.get_state())


def test_model_fused_and_unfused_agree_in_training_mode():
    """The whole model with fuse_tat + fuse_spatial and without, dropout on,
    one generator seed each: the same predictions (the masks are the same
    bits, drawn in the same order)."""
    spec = ModelSpec(num_of_vertices=12, len_input=12, num_for_predict=4, num_of_d=1,
                     nb_block=2, K=3, nb_chev_filter=8, nb_time_filter=8, d_model=16,
                     d_k=8, n_heads=2, dropout_rate=0.2)
    rng = np.random.default_rng(6)
    model = DSTAGNN(spec)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.3))
    adj = torch.from_numpy((rng.random((12, 12)) < 0.3).astype(np.float32))
    cheb = torch.from_numpy(rng.normal(size=(3, 12, 12)).astype(np.float32) * 0.3)
    x = torch.from_numpy(rng.normal(size=(2, 12, 1, 12)).astype(np.float32))
    preds = []
    for fuse in (False, True):
        preds.append(model(x, adj_pa=adj, cheb_polys=cheb, deterministic=False,
                           generator=torch.Generator().manual_seed(11),
                           fuse_tat=fuse, fuse_spatial=fuse).detach())
    np.testing.assert_allclose(preds[1].numpy(), preds[0].numpy(), atol=2e-4, rtol=2e-4)


def _kernel_args(F=4, C=4):
    a, adj, cheb = _tensors(F, C)
    ops = _core_operands(a, adj, cheb, F, C)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ops.items()}
    return [t["tat"], t["xm"], None, t["pw"], t["pb"], t["pos"], t["gs"], t["bs"], t["wqk"],
            t["bias"], t["cheb"], torch.from_numpy(a["thetas"])]


def test_kernels_refuse_what_they_do_not_take():
    args = _kernel_args()
    dims = dict(K=K, d_k=DK, keep=1.0, bf16=False)
    with pytest.raises(ValueError, match="CUDA"):
        bsf.spatial_forward_cuda(*args, **dims)
    with pytest.raises(TypeError, match="float32"):
        bsf.spatial_forward_cuda(args[0].bfloat16(), *args[1:], **dims)
    with pytest.raises(ValueError, match="contiguous"):
        bsf.spatial_forward_cuda(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                                 *args[1:], **dims)
    with pytest.raises(ValueError, match="bias must be"):
        bsf.spatial_forward_cuda(*args[:9], args[9][:, :5], *args[10:], **dims)
    g = torch.zeros(B, N, CO * T)
    relu_mask = torch.ones(B, N, CO * T, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        bsf.spatial_backward_cuda(*args, g, relu_mask, **dims)
    # the forward's ReLU mask: (B, N, Co·T) torch.bool
    with pytest.raises(ValueError, match="relu_mask must be"):
        bsf.spatial_backward_cuda(*args, g, relu_mask[:, :5], **dims)
    with pytest.raises(TypeError, match="relu_mask must be torch.bool"):
        bsf.spatial_backward_cuda(*args, g, relu_mask.float(), **dims)
    # PEMS08 width fits a block's shared memory; N = 2139 does not
    assert max(bsf.smem_bytes(170, 384, 32, 12, 32, 512, 3, 32).values()) < 227 * 1024
    assert bsf.smem_bytes(2139, 576, 4, 144, 32, 64, 2, 32)["cols_bwd"] > 227 * 1024
    # at PEMS08 widths the float32 backward takes N <= 816 and the bf16 one
    # (A_k, dagg and the theta operands in bf16 tiles) N <= 944, PEMS07's
    # N = 883 included
    widths = (384, 32, 12, 32, 512, 3, 32)
    for dtype, cap in ((torch.float32, 816), (torch.bfloat16, 944)):
        assert max(bsf.smem_bytes(cap, *widths, dtype).values()) <= 227 * 1024
        assert bsf.smem_bytes(cap + 1, *widths, dtype)["cols_bwd"] > 227 * 1024
    assert max(bsf.smem_bytes(883, *widths, torch.bfloat16).values()) <= 227 * 1024
    # the gate names the bytes, for the dtype the kernels run in
    big = [torch.zeros(1, 883, 384), torch.zeros(1, 883, 384), None,
           torch.zeros(384, 512), torch.zeros(512), torch.zeros(883, 512), torch.zeros(512),
           torch.zeros(512), torch.zeros(512, 192), torch.zeros(3, 883, 883),
           torch.zeros(3, 883, 883), torch.zeros(3, 32, 32)]
    need = bsf.smem_bytes(883, *widths)["cols_bwd"]
    with pytest.raises(ValueError, match=f"cols_bwd kernel needs {need} bytes"):
        bsf._check(*big, 3, 32, False)
    with pytest.raises(ValueError, match="CUDA"):  # admitted in bf16: refused only for the CPU
        bsf._check(*big, 3, 32, True)


def test_bf16_forward_gate_keeps_the_backward_cap():
    """The bf16 embedding and forward column passes (tensor-core layouts)
    need less shared memory than the backward's column pass at every N up
    to its cap at PEMS08 widths, so the caps stay float32 N <= 816 and bf16
    N <= 944 (PEMS07's 883 included), and N = 945 is refused naming
    cols_bwd. At PEMS08's N = 170 two bf16 column blocks fit an SM (228 KB,
    1 KB reserved a block)."""
    widths = (384, 32, 12, 32, 512, 3, 32)
    for n in range(1, 945):
        need = bsf.smem_bytes(n, *widths, torch.bfloat16)
        assert max(need["embed"], need["cols_fwd"]) < need["cols_bwd"], n
    for n, dtype in ((816, torch.float32), (883, torch.bfloat16), (944, torch.bfloat16)):
        assert max(bsf.smem_bytes(n, *widths, dtype).values()) <= 227 * 1024, (n, dtype)
    pems08 = bsf.smem_bytes(170, *widths, torch.bfloat16)
    assert pems08["embed"] == 78_848 and pems08["cols_fwd"] == 89_088
    assert 2 * (pems08["cols_fwd"] + 1024) <= 228 * 1024
    # a d at which 32 bf16 embedding rows would not fit takes 16 a block and
    # stays admitted, as float32 admits it
    assert bsf._embed_wmma_bytes(32, 12, 2048) > 227 * 1024
    wide = (20, 12, 1, 12, 8, 2048, 2, 8)
    assert bsf.smem_bytes(*wide, torch.bfloat16)["embed"] == bsf._embed_wmma_bytes(16, 12, 2048)
    for dtype in (torch.float32, torch.bfloat16):
        assert max(bsf.smem_bytes(*wide, dtype).values()) <= 227 * 1024
    n = 945
    big = [torch.zeros(1, n, 384), torch.zeros(1, n, 384), None, torch.zeros(384, 512),
           torch.zeros(512), torch.zeros(n, 512), torch.zeros(512), torch.zeros(512),
           torch.zeros(512, 192), torch.zeros(3, n, n), torch.zeros(3, n, n),
           torch.zeros(3, 32, 32)]
    need = bsf.smem_bytes(n, *widths, torch.bfloat16)["cols_bwd"]
    with pytest.raises(ValueError, match=f"cols_bwd kernel needs {need} bytes"):
        bsf._check(*big, 3, 32, True)


def test_bf16_operands_are_zero_padded_copies():
    """The tensor-core passes' bf16 copies of xm, pw and wqk: multiples of
    16 in their last two dimensions, the operand in the corner and zeros
    elsewhere; none in float32."""
    args = _kernel_args()
    xm, pw, wqk = (args[i].bfloat16().float() for i in (1, 3, 8))
    assert bsf._bf16_operands(xm, pw, wqk, False) == (None, None, None)
    for a, p in zip((xm, pw, wqk), bsf._bf16_operands(xm, pw, wqk, True)):
        assert p.dtype == torch.bfloat16
        assert p.shape[:-2] == a.shape[:-2]
        assert all(s % 16 == 0 and s - 16 < t <= s for s, t in zip(p.shape[-2:], a.shape[-2:]))
        r, c = a.shape[-2:]
        assert torch.equal(p[..., :r, :c].float(), a)
        assert not p[..., r:, :].any() and not p[..., :, c:].any()


def test_cpu_path_counts_no_launch():
    before = (bsf.fwd_launches, bsf.bwd_launches)
    args = [t.requires_grad_(True) if t is not None and t.is_floating_point() else t
            for t in _kernel_args()]
    bsf.spatial_middle(*args, K=K, d_k=DK, keep=1.0).sum().backward()
    assert (bsf.fwd_launches, bsf.bwd_launches) == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The kernels against the plain version on the card, float32 (CUDA
    cores) and bfloat16 (the embedding pass, both column passes and the row
    pass on the tensor cores): in float32 the forward within 1e-4 and every
    gradient within 3e-3, absolute and relative; in bf16 both within 1e-2
    of their scale. The cotangent is randn, zeroed within the forward
    tolerance of the ReLU kink (there one flipped mask element changes a
    whole batch row's gradients); one launch of each kernel a call, and the
    weight gradients equal bit for bit over two backward launches. The
    forward-only path under no_grad (evaluation) launches the forward
    kernel alone and agrees within the same forward tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    # (dtype, forward tolerance, gradient tolerance, tolerances scaled by the
    # largest |value|): float32 absolute, bf16 relative to the scale
    cases = ((torch.float32, 1e-4, 3e-3, False), (torch.bfloat16, 1e-2, 1e-2, True))
    for dtype, ftol, gtol, scaled in cases:
        for F, C in ((1, 1), (4, 4)):
            cpu = [None if t is None else t.to(dtype) for t in _kernel_args(F, C)]
            cpu[2] = (torch.rand(B, N, D, generator=gen) < 0.8).to(dtype)
            leaves = [[None if t is None else t.cuda().requires_grad_(i not in (2, 10))
                       for i, t in enumerate(cpu)] for _ in range(2)]
            before = (bsf.fwd_launches, bsf.bwd_launches)
            out = bsf.spatial_middle(*leaves[0], K=K, d_k=DK, keep=0.8)
            want = bsf.spatial_middle_plain(*leaves[1], K=K, d_k=DK, keep=0.8)
            scale = max(1.0, float(want.detach().abs().max())) if scaled else 1.0
            near = torch.zeros_like(out, dtype=torch.bool)
            for o in (out.float(), want.float()):
                near |= (o > 0) & (o <= ftol * scale)
            cot = torch.randn(out.shape, generator=gen).to(dtype).cuda().masked_fill(near, 0)
            out.backward(cot)
            want.backward(cot)
            torch.cuda.synchronize()
            assert (bsf.fwd_launches, bsf.bwd_launches) == (before[0] + 1, before[1] + 1)
            torch.testing.assert_close(out.float(), want.float(), atol=ftol * scale, rtol=ftol)
            for i, (k, p) in enumerate(zip(leaves[0], leaves[1])):
                if i in (2, 10):  # the mask and the Chebyshev planes get no gradient
                    continue
                g_scale = max(1.0, float(p.grad.abs().max())) if scaled else 1.0
                torch.testing.assert_close(k.grad.float(), p.grad.float(),
                                           atol=gtol * g_scale, rtol=gtol)
            ops = bsf._kernel_operands(*[None if t is None else t.detach() for t in leaves[0]])
            bf16 = dtype == torch.bfloat16
            relu_mask = bsf.spatial_forward_cuda(*ops, K=K, d_k=DK, keep=0.8, bf16=bf16) > 0
            g = cot.float().reshape(B, N, -1).contiguous()
            first, again = (bsf.spatial_backward_cuda(*ops, g, relu_mask, K=K, d_k=DK,
                                                      keep=0.8, bf16=bf16) for _ in range(2))
            for a, b in zip(first[2:], again[2:]):  # dpw, dpb, dpos, dgs, dbs, dwqk, dbias, dΘ
                assert torch.equal(a, b)
            with torch.no_grad():
                before = (bsf.fwd_launches, bsf.bwd_launches)
                out = bsf.spatial_middle(*leaves[0], K=K, d_k=DK, keep=0.8)
                torch.cuda.synchronize()
                assert (bsf.fwd_launches, bsf.bwd_launches) == (before[0] + 1, before[1])
                torch.testing.assert_close(out.float(), want.detach().float(),
                                           atol=ftol * scale, rtol=ftol)
