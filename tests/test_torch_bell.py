"""The port's fused BELL conv (ops/cuda/bell_fused.py) and its backward
kernels' plain versions (ops/cuda/bell_bwd.py) against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

On CPU tensors the wrappers take the plain PyTorch versions; the CUDA
kernels are held against those on the card (the ``cuda`` case below,
skipped here, and chip_smoke.py). Forward atol 2e-4, gradients atol 5e-3
(precedents tests/test_parity_torch.py and tests/test_pallas_cheb.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.ops import block_sparse as jbs
from dstagnn_drought_tpu.ops.pallas import bell_bwd as jbwd
from dstagnn_drought_tpu.ops.pallas import bell_fused as jfused
from dstagnn_drought_tpu_torch.ops import block_sparse as tbs
from dstagnn_drought_tpu_torch.ops.cuda import bell_bwd, bell_fused

torch.set_num_threads(1)

CASES = {
    # ragged n=29 with BS=8, T·C = 32 < 1024
    "ragged_n29": dict(n=29, BS=8, p=0.25, C=4, T=8, Co=3, K=2, dk=4),
    # dense-ish graph: > 4 slots a target tile (the TPU's chunked kernel)
    "chunked_n48": dict(n=48, BS=8, p=0.25, C=4, T=6, Co=5, K=3, dk=8),
    # T·C = 1152 > 1024 (the TPU's fused-backward gate, not carried over)
    "tc1152_n20": dict(n=20, BS=8, p=0.3, C=8, T=144, Co=4, K=2, dk=4),
}
# the widths past the caps the card's kernels had: C = 128, Co = 256 and
# d_k = 160; a block size of 160 (two tiles of a 170-node graph)
WIDE_CASES = {
    "c128_co256_dk160": dict(n=20, BS=8, p=0.3, C=128, T=8, Co=256, K=2, dk=160),
    "bs160_n170": dict(n=170, BS=160, p=0.02, C=4, T=8, Co=4, K=2, dk=8),
}


def _case(name, seed=0, B=2, dm=12):
    c = dict({**CASES, **WIDE_CASES}[name])
    n, K, dk, C, T = c["n"], c["K"], c["dk"], c["C"], c["T"]
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) < c["p"]).astype(np.float32)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((n, n)) < 0.5) & (A > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    c.update(
        A=A, pa=pa,
        cheb=rng.normal(size=(K, n, n)).astype(np.float32),
        masks=rng.normal(size=(K, n, n)).astype(np.float32),
        thetas=(rng.normal(size=(K, C, c["Co"])) * 0.3).astype(np.float32),
        wq=(rng.normal(size=(dm, K * dk)) * 0.3).astype(np.float32),
        wk=(rng.normal(size=(dm, K * dk)) * 0.3).astype(np.float32),
        x=rng.normal(size=(B, n, C, T)).astype(np.float32),
        emb=rng.normal(size=(B, n, dm)).astype(np.float32),
    )
    c["jbell"] = jbs.block_ell_from_adjacency(A, block_size=c["BS"])
    c["bell"] = tbs.block_ell_from_adjacency(A, block_size=c["BS"])
    return c


def _jax_conv(c, path):
    """(out, grads) of sum(out·cos(out)) through the JAX Pallas wrapper."""
    bell = c["jbell"]
    if path == "tiles":
        tiles = jbs.build_bell_tile_constants(bell, c["pa"], c["cheb"])
        masks = jnp.asarray(jbs.active_tile_values(c["masks"], bell))

        def conv(x, emb, th, wq, wk, m):
            return jfused.bell_cheb_conv_tiles(
                x, emb, bell, wq=wq, wk=wk, mask_tiles=m,
                pattern_tiles=tiles["pattern_tiles"], pa_tiles=tiles["pa_tiles"],
                cheb_tiles=tiles["cheb_tiles"], thetas=th, n_heads=c["K"], d_k=c["dk"])
    else:
        masks = jnp.asarray(c["masks"])

        def conv(x, emb, th, wq, wk, m):
            return jfused.bell_cheb_conv_with_sat_pallas(
                x, emb, bell, wq=wq, wk=wk, adj_pa=jnp.asarray(c["pa"]), masks=m,
                cheb_polys=jnp.asarray(c["cheb"]), thetas=th, n_heads=c["K"], d_k=c["dk"])

    def loss(*args):
        out = conv(*args)
        return (out * jnp.cos(out)).sum(), out

    args = [jnp.asarray(c[k]) for k in ("x", "emb", "thetas", "wq", "wk")] + [masks]
    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads], np.asarray(masks)


def _port_conv(c, path, masks):
    bell = c["bell"]
    leaves = [torch.from_numpy(np.array(c[k])).requires_grad_(True)
              for k in ("x", "emb", "thetas", "wq", "wk")]
    leaves.append(torch.from_numpy(np.array(masks)).requires_grad_(True))
    x, emb, th, wq, wk, m = leaves
    if path == "tiles":
        tiles = tbs.build_bell_tile_constants(bell, c["pa"], c["cheb"])
        out = bell_fused.bell_cheb_conv_tiles(
            x, emb, bell, wq=wq, wk=wk, mask_tiles=m, pattern_tiles=tiles["pattern_tiles"],
            pa_tiles=tiles["pa_tiles"], cheb_tiles=tiles["cheb_tiles"], thetas=th,
            n_heads=c["K"], d_k=c["dk"])
    else:
        out = bell_fused.bell_cheb_conv_with_sat_pallas(
            x, emb, bell, wq=wq, wk=wk, adj_pa=torch.from_numpy(c["pa"]), masks=m,
            cheb_polys=torch.from_numpy(c["cheb"]), thetas=th, n_heads=c["K"], d_k=c["dk"])
    (out * torch.cos(out)).sum().backward()
    return out.detach().numpy(), [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("path", ["tiles", "dense"])
@pytest.mark.parametrize("name", list(CASES))
def test_conv_matches_pallas_interpret(name, path):
    c = _case(name)
    if name == "chunked_n48":
        assert c["bell"].max_blocks > 4
    j_out, j_grads, masks = _jax_conv(c, path)
    out, grads = _port_conv(c, path, masks)
    assert out.shape == (2, c["n"], c["Co"], c["T"])
    np.testing.assert_allclose(out, j_out, atol=2e-4, rtol=2e-4)
    for g, jg, nm in zip(grads, j_grads, ("x", "emb", "thetas", "wq", "wk", "masks")):
        np.testing.assert_allclose(g, jg, atol=5e-3, rtol=5e-3, err_msg=nm)


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_conv_matches_pallas_interpret(name):
    """The port's plain BELL conv (the function the card's kernels compute at
    every width) against JAX's ``bell_cheb_conv_tiles`` in interpret mode
    at widths the kernels refused before: forward within 2e-4, every
    gradient within 5e-3."""
    c = _case(name, B=1)
    j_out, j_grads, masks = _jax_conv(c, "tiles")
    out, grads = _port_conv(c, "tiles", masks)
    assert out.shape == (1, c["n"], c["Co"], c["T"])
    np.testing.assert_allclose(out, j_out, atol=2e-4, rtol=2e-4)
    for g, jg, nm in zip(grads, j_grads, ("x", "emb", "thetas", "wq", "wk", "masks")):
        np.testing.assert_allclose(g, jg, atol=5e-3, rtol=5e-3, err_msg=nm)


def _bwd_operands(seed=1, B=2, n=29, BS=8, H=2, C=8, T=16, Co=8):
    """K1/K2 operands in the c-major layout both packages share (the TPU
    c-major kernels need 128 | C·T and 128 | Co·T)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) < 0.25).astype(np.float32)
    bell = tbs.block_ell_from_adjacency(A, block_size=BS)
    Np, An = bell.padded_nodes, bell.num_active
    rows = (np.arange(Np) < n)[None, :, None]
    x = (rng.normal(size=(B, Np, C * T)) * rows).astype(np.float32)
    gm = (rng.normal(size=(B, Np, Co * T)) * rows).astype(np.float32)
    w = (rng.random((B, An, H, BS, BS)) * 0.2).astype(np.float32)
    th = (rng.normal(size=(H, C, Co)) * 0.3).astype(np.float32)
    return A, bell, x, gm, w, th, C


def test_plain_k1_k2_match_pallas_interpret():
    A, bell, x, gm, w, th, C = _bwd_operands()
    S = bell.max_blocks
    jb = jbs.block_ell_from_adjacency(A, block_size=bell.block_size)
    w_pad = np.pad(w, ((0, 0), (0, S), (0, 0), (0, 0), (0, 0)))
    j_dA, j_dth = jbwd.bell_bwd_dA_dtheta(
        jb.tile_start, jb.tile_count, jnp.pad(jb.active_src, (0, S)), jnp.asarray(th),
        jnp.asarray(gm), jnp.asarray(x), jnp.asarray(w_pad), S_max=S, n_ch=C,
        interpret=True, layout="c")
    j_dx = jbwd.bell_bwd_dx(
        jb.src_start, jb.src_count, jnp.pad(jb.active_tgt[jb.src_order], (0, S)),
        jnp.pad(jb.src_order, (0, S)), jnp.asarray(th), jnp.asarray(gm), jnp.asarray(w_pad),
        max_out=bell.max_src_blocks, n_ch=C, np_src=bell.padded_nodes, interpret=True,
        layout="c")
    t = bell.tensors
    T_ = torch.from_numpy
    dA, dth = bell_bwd.bell_k1(t["active_src"], t["active_tgt"], t["tile_start"],
                               t["tile_count"], T_(th), T_(gm), T_(x), T_(w))
    dx = bell_bwd.bell_k2(t["src_start"], t["src_count"], t["src_order"],
                          t["active_tgt"], T_(th), T_(gm), T_(w))
    np.testing.assert_allclose(dA.numpy(), np.asarray(j_dA)[:, :bell.num_active],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dth.numpy(), np.asarray(j_dth), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), atol=2e-4, rtol=2e-4)


def test_plain_k1_rounds_g_agg_to_x_dtype():
    """In bf16 the dA product takes g_agg rounded to bf16 (as the TPU
    kernel's cast before its dA matmul), and K2 keeps g_agg in float32."""
    _, bell, x, gm, w, th, _ = _bwd_operands()
    t = bell.tensors
    b = lambda a: torch.from_numpy(a).bfloat16()
    dA, _ = bell_bwd.bell_k1_plain(t["active_src"], t["active_tgt"], torch.from_numpy(th),
                                   b(gm), b(x), b(w))
    dA32, _ = bell_bwd.bell_k1_plain(t["active_src"], t["active_tgt"], torch.from_numpy(th),
                                     b(gm).float(), b(x).float(), b(w).float())
    assert dA.dtype == torch.float32 and not torch.equal(dA, dA32)
    np.testing.assert_allclose(dA.numpy(), dA32.numpy(), atol=0.1, rtol=2e-2)
    dx = bell_bwd.bell_k2_plain(t["src_start"], t["src_count"], t["src_order"],
                                t["active_tgt"], torch.from_numpy(th), b(gm), b(w))
    assert dx.dtype == torch.bfloat16


def test_wrappers_refuse_what_the_kernels_do_not_take():
    c = _case("ragged_n29")
    bell = c["bell"]
    t = bell.tensors
    z = torch.zeros
    B, H, dk, Np, A, BS = 1, 2, 4, bell.padded_nodes, bell.num_active, 8
    args = [t["tile_start"], t["tile_count"], t["active_src"],
            z(B, Np, H, dk), z(B, Np, H, dk), z(A, H, BS, BS), z(A, H, BS, BS),
            z(B, Np, 6), z(H, 2, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        bell_fused.bell_forward_cuda(*args)
    with pytest.raises(TypeError, match="int32"):
        bell_fused.bell_forward_cuda(t["tile_start"].long(), *args[1:])
    with pytest.raises(ValueError, match="x must be"):
        bell_fused.bell_forward_cuda(*args[:7], z(B, Np + 1, 6), args[8])
    k_args = [t["active_src"], t["active_tgt"], t["tile_start"],
              t["tile_count"], z(H, 2, 3), z(B, Np, 9), z(B, Np, 6), z(B, A, H, BS, BS)]
    with pytest.raises(ValueError, match="CUDA"):
        bell_bwd.bell_k1_cuda(*k_args)
    with pytest.raises(ValueError, match="CUDA"):
        bell_bwd.bell_k2_cuda(t["src_start"], t["src_count"], t["src_order"],
                              t["active_tgt"], *k_args[4:6], k_args[7])
    # what the kernels refuse by shape alone: the dtype and CUDA's grid
    # limits; every width passes
    for dtype in (torch.float32, torch.bfloat16):
        assert bell_fused.limit_error(4, 2, 256, 1024, dtype) is None
        assert "grid too large" in bell_fused.limit_error(40000, 2, 32, 32, dtype)
    assert "float32 or bfloat16" in bell_bwd.shape_error(1, 2, 4, 3, torch.float16)


# (BS, C, Co, T): the GAMBIA blocks 1-2, chip_smoke.py's other BELL shapes
# (ragged BS 8 and 16 at T = 12, one channel at T = 144), the old caps' edge,
# and past it: C = Co = 128 (GAMBIA block 2 at nb_chev_filter = 128), Co =
# 1024, BS = 256
K1_BF16_SHAPES = [(128, 4, 32, 144), (128, 32, 32, 144), (8, 4, 8, 12), (16, 4, 8, 12),
                  (16, 1, 32, 144), (128, 64, 128, 144), (120, 5, 3, 7),
                  (128, 128, 128, 144), (16, 4, 1024, 12), (256, 32, 32, 144)]
PLAN_DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("BS, C, Co, T", K1_BF16_SHAPES)
def test_k1_bf16_plan_fits_every_shape(BS, C, Co, T, dtype):
    """K1's plan fits a block's 232,448 bytes in both passes in either
    dtype, its tiles are ones the kernels take (dA: powers of two of at
    most 128 target columns and source rows, chunks of channels and output
    channels no wider than C and Co; dΘ: a multiple of 16 dividing the
    target-row tile, at most 4 partial fragments a warp), and it is the same
    on every call."""
    plan = bell_bwd.k1_plan(BS, C, Co, T, dtype)
    BSp, P = -(-BS // 16) * 16, bell_bwd._planes(dtype)
    trr = min(BSp, 128)
    assert max(plan["smem"]) <= 232448
    assert plan["tn"] in (16, 32, 64, 128) and plan["tn"] <= BSp and plan["rs"] == trr
    assert plan["cc"] <= C and plan["occ"] <= Co
    assert plan["tc"] % 16 == 0 and trr % plan["tc"] == 0 and plan["ks"] <= trr
    assert -(-plan["ocb"] // 16) <= 4 * plan["wo"] and plan["ocb"] <= max(512, -(-Co // 16) * 16)
    assert plan["smem"] == (
        bell_bwd.k1_smem_bytes(P, BS, C, Co, (plan["tn"], plan["rs"], plan["cc"], plan["occ"]), 0),
        bell_bwd.k1_smem_bytes(P, BS, C, Co, (plan["tc"], plan["ks"], plan["ocb"], plan["wo"]), 1))
    assert bell_bwd.k1_plan(BS, C, Co, T, dtype) == plan
    # the GAMBIA blocks in bf16: one dA block a (slot, head, batch), every
    # channel and output channel at once, two dΘ blocks an SM
    if BS == 128 and Co == 32 and dtype == torch.bfloat16:
        assert (plan["tn"], plan["cc"], plan["occ"]) == (128, C, Co)
        assert plan["smem"][1] <= 115712


def test_k1_bf16_plan_refuses_what_the_float32_kernels_refuse():
    """The widths K1 refused (C > 64, Co > 128, BS > 128) have plans now,
    in both dtypes, and K1's shape function admits them; its dΘ partials
    fold time groups so that they stay within 16 MiB where one group
    allows it (C = Co = 128 at GAMBIA block 2: one group, 8.9 MB)."""
    for dtype in PLAN_DTYPES:
        for BS, C, Co in ((128, 65, 32), (128, 32, 129), (136, 32, 32), (256, 128, 512)):
            assert max(bell_bwd.k1_plan(BS, C, Co, 144, dtype)["smem"]) <= 232448
            assert bell_bwd.shape_error(4, 2, C, Co, dtype) is None
    assert bell_bwd.k1_time_groups(4, 17, 128, 2, 32, 32, 144) == (18, 1)
    G, TG = bell_bwd.k1_time_groups(4, 17, 128, 2, 128, 128, 144)
    assert (G, TG) == (1, 18) and 4 * 4 * 17 * 2 * 128 * 128 * G < 16 * 2**20


# K1_BF16_SHAPES, the caps' edges of the float32 K2 (C 1/64, Co 1/512, BS
# 8/120/128), and the bf16 K2's other paths: one stage (Co = 512), a ragged
# channel group (C = 56), a padded segment (C = 5), plain loads of w (BS = 20)
K2_BF16_SHAPES = K1_BF16_SHAPES + [
    (128, 64, 512, 144), (128, 1, 512, 144), (8, 64, 512, 7), (120, 64, 1, 16),
    (120, 64, 512, 16), (64, 56, 5, 16), (48, 5, 3, 7), (20, 4, 8, 16), (32, 32, 16, 24)]


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("BS, C, Co, T", K2_BF16_SHAPES)
def test_k2_bf16_plan_fits_every_shape(BS, C, Co, T, dtype):
    """K2's plan fits a block's 232,448 bytes in either dtype, equals
    k2_smem_bytes for its own tiles, takes tiles the kernel has (nt and tr
    powers of two, tr ≥ 16 dividing pad16(BS), at most 128 dx columns a
    block, output channels in chunks of 16 or all of them), covers every
    channel and step with no empty group, and is the same on every call."""
    plan = bell_bwd.k2_plan(BS, C, Co, T, dtype)
    BSp, T8, CG = -(-BS // 16) * 16, -(-T // 8), min(C, 16)
    nt, tr, occ = plan["nt"], plan["tr"], plan["occ"]
    assert plan["smem"] <= 232448
    assert plan["smem"] == bell_bwd.k2_smem_bytes(bell_bwd._planes(dtype), BS, C, Co, nt, tr,
                                                  occ)
    assert tr in (16, 32, 64, 128) and BSp % tr == 0
    assert nt & (nt - 1) == 0 and -(-nt * CG * 8 // 16) * 16 <= 128
    assert occ % 16 == 0 and occ <= -(-Co // 16) * 16
    n_cg, n_tg = plan["groups"]
    assert n_cg * CG >= C > (n_cg - 1) * CG
    assert n_tg * nt >= T8 > (n_tg - 1) * nt
    assert bell_bwd.k2_plan(BS, C, Co, T, dtype) == plan
    # the GAMBIA blocks in bf16: two blocks an SM; block 2 in channel halves
    if BS == 128 and Co == 32 and T == 144 and dtype == torch.bfloat16:
        assert plan["smem"] <= 115712
        if C == 32:
            assert (nt, plan["groups"]) == (1, (2, 18))


def test_k2_bf16_plan_refuses_exactly_what_the_float32_k2_refuses():
    """K2 refused C > 64, Co > 512 and BS > 128; it takes them now in both
    dtypes (Co past what one chunk holds in chunks of output channels), and
    its shape function refuses only the dtype and the grid."""
    for dtype in PLAN_DTYPES:
        for BS in (8, 16, 120, 128, 136, 256):
            for C in (1, 64, 65, 256):
                for Co in (1, 512, 513, 2048):
                    for T in (1, 7, 144):
                        assert bell_bwd.k2_plan(BS, C, Co, T, dtype)["smem"] <= 232448
                        assert bell_bwd.shape_error(4, 2, C, Co, dtype) is None
        assert bell_bwd.k2_plan(128, 64, 512, 144, dtype)["tr"] == 16
        assert bell_bwd.k2_plan(128, 64, 2048, 144, dtype)["occ"] < 2048
    assert "grid too large" in bell_bwd.shape_error(65536, 1, 4, 3, torch.bfloat16)


@pytest.mark.parametrize("shape", [dict(), dict(BS=16, H=3, C=1, T=128, Co=2, n=40)])
def test_plain_bf16_k2_matches_pallas_interpret(shape):
    """The function the bf16 K2 kernel must compute: the port's K2 on bf16
    gm and w (g_agg in float32, float32 sums, one cast to bf16 at the end),
    through the wrapper the backward calls, against the JAX Pallas
    ``bell_bwd_dx`` (c-major) on the same bf16 operands in interpret mode,
    within 1e-2 of the output's scale."""
    A, bell, x, gm, w, th, C = _bwd_operands(**shape)
    S = bell.max_blocks
    jb = jbs.block_ell_from_adjacency(A, block_size=bell.block_size)
    gm16 = jnp.asarray(gm).astype(jnp.bfloat16)
    w16 = jnp.pad(jnp.asarray(w).astype(jnp.bfloat16), ((0, 0), (0, S), (0, 0), (0, 0), (0, 0)))
    j_dx = jbwd.bell_bwd_dx(
        jb.src_start, jb.src_count, jnp.pad(jb.active_tgt[jb.src_order], (0, S)),
        jnp.pad(jb.src_order, (0, S)), jnp.asarray(th), gm16, w16,
        max_out=bell.max_src_blocks, n_ch=C, np_src=bell.padded_nodes, interpret=True,
        layout="c")
    assert j_dx.dtype == jnp.bfloat16
    t = bell.tensors
    dx = bell_bwd.bell_k2(t["src_start"], t["src_count"], t["src_order"], t["active_tgt"],
                          torch.from_numpy(th), torch.from_numpy(gm).bfloat16(),
                          torch.from_numpy(w).bfloat16())
    assert dx.dtype == torch.bfloat16 and dx.shape == tuple(j_dx.shape)
    want = np.asarray(j_dx.astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(dx.float().numpy(), want, atol=1e-2 * scale, rtol=0)


# K1_BF16_SHAPES at H = 2 (the GAMBIA blocks) and H = 3 (the ragged K = 3
# shape), and the caps' edges: Co = 512, C = 64, and both
F_BF16_SHAPES = [(*shape, H) for shape in K1_BF16_SHAPES for H in (2, 3)] + [
    (128, 32, 512, 144, 2), (128, 64, 32, 144, 2), (128, 64, 512, 144, 3), (8, 64, 512, 12, 2)]


@pytest.mark.parametrize("dtype", PLAN_DTYPES)
@pytest.mark.parametrize("BS, C, Co, T, H", F_BF16_SHAPES)
def test_f_bf16_plan_fits_every_shape(BS, C, Co, T, H, dtype):
    """The forward's plan fits a block's 232,448 bytes in either dtype,
    equals f_wmma_smem_bytes for its own tiles, takes tiles the kernel has
    (TN a power of two of at most pad16(BS); warp tiles of at most 8
    fragments a head, 16 for the heads of a stage, 8 in float32; a stage
    region that holds Θ's split for 16 output columns),
    covers every step, and is the same on every call."""
    plan = bell_fused.f_plan(BS, C, Co, T, H, dtype)
    BSp, P = -(-BS // 16) * 16, bell_bwd._planes(dtype)
    cc, nt = plan["cc"], plan["nt"]
    assert plan["smem"] <= 232448
    assert plan["smem"] == bell_fused.f_wmma_smem_bytes(P, C, H, plan["tn"], nt, plan["kc"],
                                                        plan["hg"], cc, plan["ocb"])
    assert (bell_fused.f_wmma_stage_bytes(P, cc, plan["tn"], nt, plan["kc"], plan["hg"])
            >= 4 * (-(-plan["hg"] * cc // 16) * 16) * 24)
    assert plan["tn"] in (16, 32, 64, 128) and plan["tn"] <= BSp
    assert plan["kc"] in (16, 32) and plan["hg"] in (1, 2)
    frags = plan["tn"] // 16 * bell_fused._f_cw(cc, nt)
    assert frags <= 8 and frags * plan["hg"] <= 16 // P and plan["hg"] <= H
    assert 1 <= nt <= -(-T // 8) and cc <= min(C, 64) and plan["ocb"] % 16 == 0
    assert bell_fused.f_plan(BS, C, Co, T, H, dtype) == plan
    if (BS, C, Co, T, H, dtype) == (128, 32, 32, 144, 2, torch.bfloat16):
        # GAMBIA block 2: one 8-step chunk, every channel and head at once
        assert (nt, plan["tn"], plan["hg"], cc, plan["ocb"]) == (1, 64, 2, 32, 32)


def test_f_bf16_plan_refuses_what_the_float32_kernels_refuse():
    """The widths the forward refused (C > 64, Co > 512, BS > 128, d_k >
    128, and every head's aggregation past H·C ≈ 340: H = 6 at C = 64) have
    plans now in both dtypes, and the gate admits them."""
    for dtype in PLAN_DTYPES:
        for BS, C, Co, H in ((128, 65, 32, 2), (128, 32, 513, 2), (136, 32, 32, 2),
                             (128, 64, 5, 6), (256, 128, 1024, 3)):
            assert bell_fused.f_plan(BS, C, Co, 144, H, dtype)["smem"] <= 232448
            assert bell_fused.limit_error(4, H, C, Co, dtype) is None
    assert bell_fused.f_weights_smem_bytes(512) == bell_fused.f_weights_smem_bytes(128)


@pytest.mark.parametrize("name", ["ragged_n29", "tc1152_n20"])
def test_plain_bf16_forward_matches_pallas_interpret(name):
    """The function the bf16 kernel must compute: the port's plain forward
    on bf16 x (w rounded to bf16, float32 sums, the Θ mix on the float32
    aggregation, one cast to bf16) against the JAX Pallas forward on the
    same bf16 x in interpret mode, through the wrappers the model calls,
    within 1e-2 of the output's scale."""
    c = _case(name)
    bell, jb = c["bell"], c["jbell"]
    tiles = jbs.build_bell_tile_constants(jb, c["pa"], c["cheb"])
    masks = np.asarray(jbs.active_tile_values(c["masks"], jb))
    x16 = jnp.asarray(c["x"]).astype(jnp.bfloat16)
    j_out = jfused.bell_cheb_conv_tiles(
        x16, jnp.asarray(c["emb"]), jb, wq=jnp.asarray(c["wq"]), wk=jnp.asarray(c["wk"]),
        mask_tiles=jnp.asarray(masks), pattern_tiles=tiles["pattern_tiles"],
        pa_tiles=tiles["pa_tiles"], cheb_tiles=tiles["cheb_tiles"],
        thetas=jnp.asarray(c["thetas"]), n_heads=c["K"], d_k=c["dk"])
    assert j_out.dtype == jnp.bfloat16
    t_tiles = tbs.build_bell_tile_constants(bell, c["pa"], c["cheb"])
    T_ = torch.from_numpy
    out = bell_fused.bell_cheb_conv_tiles(
        T_(c["x"]).bfloat16(), T_(c["emb"]), bell, wq=T_(c["wq"]), wk=T_(c["wk"]),
        mask_tiles=T_(masks), pattern_tiles=t_tiles["pattern_tiles"],
        pa_tiles=t_tiles["pa_tiles"], cheb_tiles=t_tiles["cheb_tiles"],
        thetas=T_(c["thetas"]), n_heads=c["K"], d_k=c["dk"])
    assert out.dtype == torch.bfloat16 and out.shape == (2, c["n"], c["Co"], c["T"])
    want = np.asarray(j_out.astype(jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-2 * scale, rtol=0)


def test_cpu_path_counts_no_launch():
    c = _case("ragged_n29")
    before = (bell_fused.launches, bell_bwd.k1_launches, bell_bwd.k2_launches)
    _port_conv(c, "tiles", jbs.active_tile_values(c["masks"], c["jbell"]))
    assert (bell_fused.launches, bell_bwd.k1_launches, bell_bwd.k2_launches) == before


def test_refuses_a_graph_without_in_edges():
    c = _case("ragged_n29")
    A = c["A"].copy()
    A[:, 3] = 0
    bell = tbs.block_ell_from_adjacency(A, block_size=8, include_self=False)
    assert not bell.covered
    tiles = tbs.build_bell_tile_constants(bell, c["pa"], c["cheb"])
    with pytest.raises(ValueError, match="in-edge"):
        bell_fused.bell_cheb_conv_tiles(
            torch.from_numpy(c["x"]), torch.from_numpy(c["emb"]), bell,
            wq=torch.from_numpy(c["wq"]), wk=torch.from_numpy(c["wk"]),
            mask_tiles=torch.zeros(bell.num_active, 2, 8, 8),
            pattern_tiles=tiles["pattern_tiles"], pa_tiles=tiles["pa_tiles"],
            cheb_tiles=tiles["cheb_tiles"], thetas=torch.from_numpy(c["thetas"]),
            n_heads=2, d_k=4)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, bell, x, gm, w, th, _ = _bwd_operands()
    bell = bell.to("cuda")
    t = bell.tensors
    cu = lambda a: torch.from_numpy(a).cuda().contiguous()
    k1 = (t["active_src"], t["active_tgt"], t["tile_start"], t["tile_count"],
          cu(th), cu(gm), cu(x), cu(w))
    dA, dth = bell_bwd.bell_k1(*k1)
    dA_p, dth_p = bell_bwd.bell_k1_plain(*k1[:2], *k1[4:])
    torch.testing.assert_close(dA, dA_p, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(dth, dth_p, atol=2e-4, rtol=2e-4)
    assert torch.equal(bell_bwd.bell_k1(*k1)[1], dth)
    # the bf16 design (tensor cores): within 1e-2 of scale of the plain
    # version on the same bf16 operands, dΘ bit for bit over two launches
    k1_16 = (*k1[:5], *(t.bfloat16().contiguous() for t in k1[5:]))
    before = bell_bwd.k1_launches
    dA16, dth16 = bell_bwd.bell_k1(*k1_16)
    assert bell_bwd.k1_launches == before + 1
    dA16_p, dth16_p = bell_bwd.bell_k1_plain(*k1_16[:2], *k1_16[4:])
    for got, want in ((dA16, dA16_p), (dth16, dth16_p)):
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-2 * max(1.0, float(want.abs().max()))
    assert torch.equal(bell_bwd.bell_k1(*k1_16)[1], dth16)
    k2 = (t["src_start"], t["src_count"], t["src_order"], t["active_tgt"],
          cu(th), cu(gm), cu(w))
    torch.testing.assert_close(bell_bwd.bell_k2(*k2), bell_bwd.bell_k2_plain(*k2),
                               atol=2e-4, rtol=2e-4)
    # the forward on the same graph, with bias and Chebyshev tiles on its pattern
    B, Np, H, C = x.shape[0], bell.padded_nodes, th.shape[0], th.shape[1]
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    pattern = t["active_pattern"][:, None]
    shape = (bell.num_active, H, bell.block_size, bell.block_size)
    f = (t["tile_start"], t["tile_count"], t["active_src"],
         rnd(B, Np, H, 4), rnd(B, Np, H, 4),
         torch.where(pattern, rnd(*shape), torch.tensor(-1e30, device="cuda")).contiguous(),
         (rnd(*shape) * pattern).contiguous(), cu(x), cu(th))
    before = bell_fused.launches
    out = bell_fused.bell_forward(*f)
    assert bell_fused.launches == before + 1
    torch.testing.assert_close(out, bell_fused.bell_forward_plain(*f), atol=2e-4, rtol=2e-4)
    # the bf16 design (tensor cores): within 1e-2 of scale of the plain
    # version on the same bf16 x, the same bits over two launches
    f16 = (*f[:7], f[7].bfloat16().contiguous(), f[8])
    out16 = bell_fused.bell_forward(*f16)
    assert bell_fused.launches == before + 2 and out16.dtype == torch.bfloat16
    want = bell_fused.bell_forward_plain(*f16).float()
    assert float((out16.float() - want).abs().max()) <= 1e-2 * max(1.0, float(want.abs().max()))
    assert torch.equal(bell_fused.bell_forward(*f16), out16)


@pytest.mark.cuda
def test_bf16_k2_matches_plain_on_card():
    """The bf16 K2 (tensor cores) against its plain version on the same bf16
    operands within 1e-2 of scale, one launch a call, the same bits over
    two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    _, bell, _, gm, w, th, _ = _bwd_operands()
    t = bell.to("cuda").tensors
    cu16 = lambda a: torch.from_numpy(a).cuda().bfloat16().contiguous()
    k2 = (t["src_start"], t["src_count"], t["src_order"], t["active_tgt"],
          torch.from_numpy(th).cuda(), cu16(gm), cu16(w))
    before = bell_bwd.k2_launches
    dx = bell_bwd.bell_k2(*k2)
    assert bell_bwd.k2_launches == before + 1 and dx.dtype == torch.bfloat16
    want = bell_bwd.bell_k2_plain(*k2).float()
    assert float((dx.float() - want).abs().max()) <= 1e-2 * max(1.0, float(want.abs().max()))
    assert torch.equal(bell_bwd.bell_k2(*k2), dx)
