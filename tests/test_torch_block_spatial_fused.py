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
    # PEMS08 width fits a block's shared memory, and so does N = 2139: the
    # passes stream the source and target axes in tiles
    assert max(bsf.smem_bytes(170, 384, 32, 12, 32, 512, 3, 32).values()) < 227 * 1024
    assert max(bsf.smem_bytes(2139, 576, 4, 144, 32, 64, 2, 32).values()) < 227 * 1024
    # at PEMS08 widths both dtypes take N past the old caps (float32 816,
    # bf16 944), PEMS07's N = 883 included
    widths = (384, 32, 12, 32, 512, 3, 32)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (816, 817, 883, 944, 945):
            assert max(bsf.smem_bytes(n, *widths, dtype).values()) <= 227 * 1024
    # the gate admits PEMS07 in both dtypes: refused only for the CPU
    big = [torch.zeros(1, 883, 384), torch.zeros(1, 883, 384), None,
           torch.zeros(384, 512), torch.zeros(512), torch.zeros(883, 512), torch.zeros(512),
           torch.zeros(512), torch.zeros(512, 192), torch.zeros(3, 883, 883),
           torch.zeros(3, 883, 883), torch.zeros(3, 32, 32)]
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            bsf._check(*big, 3, 32, bf16)
    # what it refused before the kernels took C, Co and d in chunks (one
    # time step's channels past a chunk's 384 columns, a d too wide for the
    # embedding block) it admits, within a block's bytes; what it still
    # refuses is CUDA's grid, named
    for shape in ((20, 12, 385, 12, 32, 64, 2, 8), (20, 12, 1, 12, 8, 4096, 2, 8)):
        assert bsf.limit_error(*shape, torch.float32) is None
        assert max(bsf.smem_bytes(*shape).values()) <= 227 * 1024
    assert "grid too large" in bsf.limit_error(20, 12, 1, 12, 8, 64, 2, 8, torch.float32,
                                               B=65536)


def test_bf16_forward_gate_keeps_the_backward_cap():
    """The backward's cap on N is gone with the (N, 16) planes: at PEMS08
    widths every pass of both directions needs the same bytes at every N
    from 1 to 4096 in bf16, the forward's column pass no more than the
    backward's, and N = 945, past the old bf16 cap, is admitted. At PEMS08's
    N = 170 three bf16 column blocks fit an SM (228 KB, 1 KB reserved a
    block); the embedding pass keeps its 78,848 bytes."""
    widths = (384, 32, 12, 32, 512, 3, 32)
    first = bsf.smem_bytes(1, *widths, torch.bfloat16)
    for n in range(1, 4097, 7):
        need = bsf.smem_bytes(n, *widths, torch.bfloat16)
        assert need == first, n
        assert need["cols_fwd"] <= need["cols_bwd"], n
    for n, dtype in ((816, torch.float32), (883, torch.bfloat16), (944, torch.bfloat16)):
        assert max(bsf.smem_bytes(n, *widths, dtype).values()) <= 227 * 1024, (n, dtype)
    pems08 = bsf.smem_bytes(170, *widths, torch.bfloat16)
    # cols: keys (16, 32 + 4), queries (64, 32), stats, agg and out (16,
    # 384) float32; A's hi and lo tiles (64, 16) bf16
    assert pems08["embed"] == 78_848
    assert pems08["cols_fwd"] == (4 * (16 * 36 + 64 * 32 + 32 + 2 * 16 * 384)
                                  + 2 * 2 * 64 * 16) == 63_872
    assert 3 * (pems08["cols_fwd"] + 1024) <= 228 * 1024
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
    with pytest.raises(ValueError, match="CUDA"):  # admitted: refused only for the CPU
        bsf._check(*big, 3, 32, True)


def test_bf16_operands_are_zero_padded_copies():
    """The bf16 embedding pass's copies of pw and wqk: multiples of 16 in
    both dimensions, the operand in the corner and zeros elsewhere; none in
    float32. The tensor-core products' copy of xm, by time chunk: (B, nTc,
    Npad, CTcp) with element [b, h, i, c·Tc + t] = xm[b, i, c·T + h·Tc + t]
    and zeros past N, past T and past C·Tc; in bf16 one exact copy, in
    float32 hi + lo within 2^-17 of xm."""
    args = _kernel_args()
    pw, wqk = (args[i].bfloat16().float() for i in (3, 8))
    assert bsf._bf16_operands(pw, wqk, False) == (None, None)
    for a, p in zip((pw, wqk), bsf._bf16_operands(pw, wqk, True)):
        assert p.dtype == torch.bfloat16
        assert all(s % 16 == 0 and s - 16 < t <= s for s, t in zip(p.shape, a.shape))
        r, c = a.shape
        assert torch.equal(p[:r, :c].float(), a)
        assert not p[r:, :].any() and not p[:, c:].any()
    n, C, T_, Co = 45, 40, 13, 8  # 384 // 40 = 9 steps a chunk: 7 + 6, ragged
    xm = torch.randn(2, n, C * T_)
    Tc, nTc, CTcp, Npad = bsf.chunk_layout(n, C, T_, Co)
    assert (Tc, nTc, CTcp, Npad) == (7, 2, 288, 64)
    for bf16 in (True, False):
        x = xm.bfloat16().float() if bf16 else xm
        hi, lo = bsf._xm_chunks(x, C, T_, Co, bf16)
        assert hi.shape == (2, nTc, Npad, CTcp) and hi.dtype == torch.bfloat16
        full = hi.float() + (0 if lo is None else lo.float())
        assert (lo is None) == bf16
        x4 = x.reshape(2, n, C, T_)
        for h in range(nTc):
            steps = min(Tc, T_ - h * Tc)
            got = full[:, h, :n, :C * Tc].reshape(2, n, C, Tc)
            torch.testing.assert_close(got[..., :steps], x4[..., h * Tc:h * Tc + steps],
                                       atol=0, rtol=0 if bf16 else 2 ** -17)
            assert not got[..., steps:].any()
        assert not full[:, :, n:].any() and not full[..., C * Tc:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", [(12, 1, 12, 32, 512, 3, 32), (384, 32, 12, 32, 512, 3, 32),
                                    (576, 4, 144, 32, 64, 2, 32),
                                    (4608, 32, 144, 32, 64, 2, 32)],
                         ids=["pems08_block1", "pems08_blocks2-4", "gambia_block1",
                              "gambia_block2"])
def test_smem_bytes_do_not_grow_with_n(widths, dtype):
    """Every pass's shared memory is the same at N = 170, 883, 2139 and 8192
    (PEMS08, PEMS07, GAMBIA and beyond), at PEMS08's and GAMBIA's block
    widths, and fits a block: the tiles, d_k, d and the time chunk set it."""
    FT, C, T_, Co, d, k, dk = widths
    need = [bsf.smem_bytes(n, FT, C, T_, Co, d, k, dk, dtype) for n in (170, 883, 2139, 8192)]
    assert all(x == need[0] for x in need)
    assert max(need[0].values()) <= 227 * 1024
    assert bsf.limit_error(8192, FT, C, T_, Co, d, k, dk, dtype) is None


def test_cpu_path_counts_no_launch():
    before = (bsf.fwd_launches, bsf.bwd_launches)
    args = [t.requires_grad_(True) if t is not None and t.is_floating_point() else t
            for t in _kernel_args()]
    bsf.spatial_middle(*args, K=K, d_k=DK, keep=1.0).sum().backward()
    assert (bsf.fwd_launches, bsf.bwd_launches) == before


@pytest.mark.parametrize("F,C", [(1, 1), (4, 4)], ids=["F1", "F4"])
def test_nosplit_controls_miss_the_split_limit(F, C):
    """chip_smoke.py's split check holds the float32 spatial passes within
    SPATIAL_SPLIT_TOL of the plain float32 version; its controls, the
    function with the operands of the N²·C·T products rounded to bf16 in
    the forward (agg) or in the backward only (dA, dxm; the forward exact,
    so the ReLU mask is the plain one), must each miss that limit, and with
    no rounding the control is the plain version. Run on the CPU at the
    tests' shape."""
    import chip_smoke

    gen = torch.Generator().manual_seed(3)
    args = _kernel_args(F, C)
    args[2] = (torch.rand(B, N, D, generator=gen) < 0.8).float()
    dims = dict(K=K, d_k=DK, keep=0.8)
    cot = [torch.randn(B, N, CO * T, generator=gen)]
    diff = chip_smoke.SPATIAL_DIFF
    outs_p, grads_p = chip_smoke._grad_run(lambda a: bsf.spatial_middle_plain(*a, **dims),
                                           args, cot, diff)
    errs = {}
    for fwd, bwd in ((False, False), (True, False), (False, True)):
        outs, grads = chip_smoke._grad_run(
            lambda a: chip_smoke.spatial_nosplit_plain(*a, **dims, fwd=fwd, bwd=bwd),
            args, cot, diff)
        errs[fwd, bwd] = (chip_smoke._compare(outs, outs_p)[1],
                          chip_smoke._compare(grads, grads_p)[1])
    assert max(errs[False, False]) <= 1e-6
    assert errs[True, False][0] > chip_smoke.SPATIAL_SPLIT_TOL
    assert errs[False, True][0] == errs[False, False][0]
    assert errs[False, True][1] > chip_smoke.SPATIAL_SPLIT_TOL


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


# ---------------------------------------------------------------------------
# The kernels' split schedule, emulated in torch on the CPU
# ---------------------------------------------------------------------------

def _split_middle(qk, xm, bias, cheb, thetas, K, d_k, tile, step, Tc, g=None, y=None):
    """The column and row passes of csrc/block_spatial_fused.cu in float32,
    in their order and tiles: ``tile`` targets (or sources) a block,
    ``step`` sources (or targets) streamed a step, Tc time steps a chunk.
    Forward (``g`` None): stats, then the forward column pass → y. Backward:
    stats, cols_bwd (agg again, dΘ, dagg, δ_j = dagg_j·agg_j a chunk), ds
    (dA, ds = att (cheb dA − δ), dbias summed over b in order, dk), dq and
    the dxm row pass → (dqk, dxm, dbias, dΘ)."""
    B, N, _ = qk.shape
    C, Co = thetas.shape[1:]
    T = xm.shape[-1] // C
    hk, inv = K * d_k, 1.0 / d_k ** 0.5
    x4 = xm.reshape(B, N, C, T)
    chunks = [(t0, min(Tc, T - t0)) for t0 in range(0, T, Tc)]
    tiles = [(j0, min(j0 + tile, N)) for j0 in range(0, N, tile)]
    steps = [(i0, min(i0 + step, N)) for i0 in range(0, N, step)]
    q = lambda b, k, r: qk[b, r[0]:r[1], k * d_k:(k + 1) * d_k]
    kk = lambda b, k, r: qk[b, r[0]:r[1], hk + k * d_k:hk + (k + 1) * d_k]
    score = lambda b, k, ri, rj: (q(b, k, ri) @ kk(b, k, rj).T * inv
                                  + bias[k, ri[0]:ri[1], rj[0]:rj[1]])
    stats = torch.zeros(B, K, N, 2)
    for b in range(B):
        for k in range(K):
            for rj in tiles:  # running max and sum of exp over the streamed sources
                m = torch.full((rj[1] - rj[0],), -float("inf"))
                l = torch.zeros(rj[1] - rj[0])
                for ri in steps:
                    s = score(b, k, ri, rj)
                    mt = torch.maximum(m, s.max(0).values)
                    l = l * torch.exp(m - mt) + torch.exp(s - mt).sum(0)
                    m = mt
                stats[b, k, rj[0]:rj[1]] = torch.stack([m, l], -1)

    def A(b, k, ri, rj):
        st = stats[b, k, rj[0]:rj[1]]
        att = torch.exp(score(b, k, ri, rj) - st[:, 0]) / st[:, 1]
        return cheb[k, ri[0]:ri[1], rj[0]:rj[1]] * att, att

    def aggregate(b, k, rj, t0, tc):
        agg = torch.zeros(rj[1] - rj[0], C, tc)
        for ri in steps:
            agg += torch.einsum("ij,ict->jct", A(b, k, ri, rj)[0],
                                x4[b, ri[0]:ri[1], :, t0:t0 + tc])
        return agg

    if g is None:
        out = torch.zeros(B, N, Co, T)
        for b in range(B):
            for rj in tiles:
                for t0, tc in chunks:
                    for k in range(K):
                        out[b, rj[0]:rj[1], :, t0:t0 + tc] += torch.einsum(
                            "jct,co->jot", aggregate(b, k, rj, t0, tc), thetas[k])
        return torch.relu(out).reshape(B, N, Co * T)
    gm = (g * (y > 0)).reshape(B, N, Co, T)
    dagg = torch.zeros(B, K, N, C, T)
    delta = torch.zeros(B, K, len(chunks), N)
    dth = torch.zeros_like(thetas)
    for b in range(B):
        for rj in tiles:
            for h, (t0, tc) in enumerate(chunks):
                for k in range(K):
                    agg = aggregate(b, k, rj, t0, tc)
                    gc = gm[b, rj[0]:rj[1], :, t0:t0 + tc]
                    dth[k] += torch.einsum("jct,jot->co", agg, gc)
                    da = torch.einsum("jot,co->jct", gc, thetas[k])
                    dagg[b, k, rj[0]:rj[1], :, t0:t0 + tc] = da
                    delta[b, k, h, rj[0]:rj[1]] = (da * agg).sum((1, 2))
    dbias = torch.zeros_like(bias)
    dS = torch.zeros(B, K, N, N)
    dqk = torch.zeros_like(qk)
    for rj in tiles:
        for k in range(K):
            for b in range(B):  # b in order inside the block, as dbias is summed
                dl = delta[b, k, :, rj[0]:rj[1]].sum(0)
                dk = torch.zeros(rj[1] - rj[0], d_k)
                for ri in steps:
                    _, att = A(b, k, ri, rj)
                    dA = xm[b, ri[0]:ri[1]] @ dagg[b, k, rj[0]:rj[1]].reshape(-1, C * T).T
                    ds = att * (cheb[k, ri[0]:ri[1], rj[0]:rj[1]] * dA - dl)
                    dbias[k, ri[0]:ri[1], rj[0]:rj[1]] += ds
                    dS[b, k, ri[0]:ri[1], rj[0]:rj[1]] = ds
                    dk += ds.T @ q(b, k, ri)
                dqk[b, rj[0]:rj[1], hk + k * d_k:hk + (k + 1) * d_k] = dk * inv
    dxm = torch.zeros(B, N, C, T)
    for b in range(B):
        for ri in tiles:  # the row passes: source tiles, targets streamed
            for k in range(K):
                dq = torch.zeros(ri[1] - ri[0], d_k)
                for rj in steps:
                    dq += dS[b, k, ri[0]:ri[1], rj[0]:rj[1]] @ kk(b, k, rj)
                    dxm[b, ri[0]:ri[1]] += torch.einsum("ij,jct->ict", A(b, k, ri, rj)[0],
                                                        dagg[b, k, rj[0]:rj[1]])
                dqk[b, ri[0]:ri[1], k * d_k:(k + 1) * d_k] = dq * inv
    return dqk, dxm.reshape(B, N, C * T), dbias, dth


class _SplitMiddle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qk, xm, bias, cheb, thetas, K, d_k, tile, step, Tc):
        ctx.dims = (K, d_k, tile, step, Tc)
        y = _split_middle(qk, xm, bias, cheb, thetas, *ctx.dims)
        ctx.save_for_backward(qk, xm, bias, cheb, thetas, y)
        return y

    @staticmethod
    def backward(ctx, g):
        qk, xm, bias, cheb, thetas, y = ctx.saved_tensors
        dqk, dxm, dbias, dth = _split_middle(qk, xm, bias, cheb, thetas, *ctx.dims, g=g, y=y)
        return dqk, dxm, dbias, None, dth, None, None, None, None, None


def _split_schedule(t, adj, cheb, N_, k, tile, step, Tc):
    """fused_spatial_middle's arguments through the emulated schedule: the
    embedding in torch ops (autograd), the middle in _SplitMiddle."""
    Bx, F, T_, _ = t["tat"].shape
    C = t["x"].shape[2]
    pw = t["pre_w"][:, :, 0, :].permute(2, 1, 0).reshape(F * T_, D)
    z = t["tat"].reshape(Bx, F * T_, N_).transpose(1, 2) @ pw + t["pre_b"] + t["pos"]
    mu = z.mean(-1, keepdim=True)
    var = ((z - mu) ** 2).mean(-1, keepdim=True)
    semx = (z - mu) * torch.rsqrt(var + 1e-5) * t["gs"] + t["bs"]
    qk = semx @ torch.cat([t["wq"], t["wk"]], dim=1)
    out = _SplitMiddle.apply(qk, t["x"].reshape(Bx, N_, C * T_), adj[None] * t["masks"], cheb,
                             t["thetas"], k, DK, tile, step, Tc)
    return out.reshape(Bx, N_, t["thetas"].shape[-1], T_)


def test_split_schedule_matches_plain_and_jax():
    """The kernels' algorithm on the CPU: N = 45 with 16-wide tiles (ragged
    tails of 13 on both axes) and a time chunk of 4 that splits T = 6 into
    4 + 2, the column statistics streamed, δ_j = dagg_j·agg_j a chunk, dbias
    summed over b in order. Forward and every gradient against the plain
    version (autograd) and JAX's fused_spatial_middle (Pallas, interpret
    mode) within 2e-4 / 5e-3 (chip_smoke's TOL and GRAD_TOL)."""
    n, F, C, k2 = 45, 2, 3, 2
    rng = np.random.default_rng(12)
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    a = dict(tat=mk(B, F, T, n), x=mk(B, n, C, T), pre_w=mk(D, T, 1, F), pre_b=mk(D),
             pos=mk(n, D), gs=np.full(D, 1.05, np.float32), bs=np.full(D, 0.02, np.float32),
             wq=mk(D, k2 * DK), wk=mk(D, k2 * DK), masks=mk(k2, n, n),
             thetas=mk(k2, C, CO))
    adj = (rng.random((n, n)) < 0.3).astype(np.float32)
    cheb = mk(k2, n, n)
    cot = rng.normal(size=(B, n, CO, T)).astype(np.float32)
    runs = {}
    for name in ("split", "plain"):
        t = {key: torch.from_numpy(v).requires_grad_(True) for key, v in a.items()}
        adj_t, cheb_t = torch.from_numpy(adj), torch.from_numpy(cheb)
        if name == "split":
            out = _split_schedule(t, adj_t, cheb_t, n, k2, tile=16, step=16, Tc=4)
        else:
            out = bsf.fused_spatial_middle(t["tat"], t["x"], **_kw(t, adj_t, cheb_t, k2))
        out.backward(torch.from_numpy(cot))
        runs[name] = (out.detach().numpy(), {key: v.grad.numpy() for key, v in t.items()})
    j_out, j_vjp = jax.vjp(lambda t: jbsf.fused_spatial_middle(
        t["tat"], t["x"], **_kw(t, jnp.asarray(adj), jnp.asarray(cheb), k2)),
        {key: jnp.asarray(v) for key, v in a.items()})
    (j_g,) = j_vjp(jnp.asarray(cot))
    runs["jax"] = (np.asarray(j_out), {key: np.asarray(v) for key, v in j_g.items()})
    got_out, got_g = runs.pop("split")
    assert float(np.abs(got_out).max()) > 0.1  # the ReLU leaves a live output
    for name, (want_out, want_g) in runs.items():
        np.testing.assert_allclose(got_out, want_out, atol=2e-4, rtol=2e-4, err_msg=name)
        for key in ("tat", "x", *PARAMS):
            np.testing.assert_allclose(got_g[key], want_g[key], atol=5e-3, rtol=5e-3,
                                       err_msg=f"{name} {key}")
