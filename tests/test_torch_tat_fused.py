"""The port's fused temporal attention (ops/cuda/tat_fused.py) against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA kernels
are held against that version on the card (the ``cuda`` case below, skipped
here, and chip_smoke.py), and the float32 passes against the plain float32
version where a no-split control misses it. The gate tests check which shapes
the passes admit in each dtype, and that the bytes follow
csrc/tat_fused.cu's formulas.
Tolerances are the JAX fused-kernel tests' (tests/test_tat_fused.py): forward 1e-4, gradients 2e-3; in bfloat16 one
bf16 ulp of the output's scale (2^-7 ≈ 8e-3 at |x| < 2, both sides compute
in float32 and round once).
"""
import numpy as np
import pytest
import torch

try:  # the reference; a machine with the card but no JAX runs only the cuda case
    import jax
    import jax.numpy as jnp

    from dstagnn_drought_tpu.ops.pallas.tat_fused import (
        fused_temporal_attention as jax_fused,
    )
except ImportError:
    jax = jnp = jax_fused = None
from dstagnn_drought_tpu_torch.ops.cuda import tat_fused

torch.set_num_threads(1)

B, F, T, N, H, DK, DV = 2, 3, 6, 20, 2, 8, 8
NAMES = ("x", "pos", "g0", "b0", "wq", "wk", "wv", "wo", "g1", "b1", "res")


def _tensors(seed=0, res_shape=(B, F, H, T, T)):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    return dict(
        x=mk(B, F, T, N), pos=mk(T, N),
        g0=np.full(N, 1.1, np.float32), b0=np.full(N, 0.05, np.float32),
        wq=mk(N, H * DK), wk=mk(N, H * DK), wv=mk(N, H * DV), wo=mk(H * DV, N),
        g1=np.full(N, 0.9, np.float32), b1=np.full(N, -0.02, np.float32),
        res=mk(*res_shape),
    )


def _kw(a, embed, lib):
    return dict(pos=a["pos"] if embed else None, ln0_scale=a["g0"] if embed else None,
                ln0_bias=a["b0"] if embed else None, wq=a["wq"], wk=a["wk"], wv=a["wv"],
                wo=a["wo"], ln_scale=a["g1"], ln_bias=a["b1"], n_heads=H, d_k=DK, d_v=DV)


def _loss(o, s, lib):
    return (o ** 2).sum() + lib.sin(s).sum()


def _jax(a, embed, scalar_res):
    def f(t):
        res = jnp.zeros(()) if scalar_res else t["res"]
        o, s = jax_fused(t["x"], res, **_kw(t, embed, jnp))
        return _loss(o, s, jnp), (o, s)

    (_, (o, s)), g = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in a.items()})
    return np.asarray(o), np.asarray(s), {k: np.asarray(v) for k, v in g.items()}


def _port(a, embed, scalar_res, dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(dtype).requires_grad_(True) for k, v in a.items()}
    res = torch.zeros((), dtype=dtype) if scalar_res else t["res"]
    o, s = tat_fused.fused_temporal_attention(t["x"], res, **_kw(t, embed, torch))
    _loss(o.float(), s.float(), torch).backward()
    return o, s, t


@pytest.mark.parametrize("res", ["broadcast", "scalar"])
@pytest.mark.parametrize("embed", [True, False], ids=["embed", "no_embed"])
def test_forward_and_grads_match_jax(embed, res):
    """res 'broadcast' is the (B, 1, H, T, T) score residual of block 2,
    spread over F; 'scalar' is block 1's zero."""
    a = _tensors(res_shape=(B, 1, H, T, T))
    scalar = res == "scalar"
    j_o, j_s, j_g = _jax(a, embed, scalar)
    o, s, t = _port(a, embed, scalar)
    assert o.shape == (B, F, T, N) and s.shape == (B, F, H, T, T)
    np.testing.assert_allclose(o.detach().numpy(), j_o, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s.detach().numpy(), j_s, atol=1e-4, rtol=1e-4)
    for name in NAMES:
        if (name == "res" and scalar) or (name in ("pos", "g0", "b0") and not embed):
            assert t[name].grad is None
            continue
        np.testing.assert_allclose(t[name].grad.numpy(), j_g[name], atol=2e-3, rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("embed", [True, False], ids=["embed", "no_embed"])
def test_bfloat16_forward_matches_jax(embed):
    a = _tensors(seed=1)
    bf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in a.items()}
    j_o, j_s = jax_fused(bf["x"], bf["res"], **_kw(bf, embed, jnp))
    t = {k: torch.from_numpy(v).bfloat16() for k, v in a.items()}
    o, s = tat_fused.fused_temporal_attention(t["x"], t["res"], **_kw(t, embed, torch))
    assert o.dtype == s.dtype == torch.bfloat16
    for got, want in ((o, j_o), (s, j_s)):
        want = np.asarray(want.astype(jnp.float32))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3 * scale, rtol=8e-3)


def _kernel_args(dtype=torch.float32):
    a = _tensors()
    x = torch.from_numpy(a["x"]).reshape(B * F, T, N)
    wqkv = torch.from_numpy(np.concatenate([a["wq"], a["wk"], a["wv"]], axis=1))
    args = [x, torch.from_numpy(a["pos"]), torch.from_numpy(a["g0"]),
            torch.from_numpy(a["b0"]), wqkv, torch.from_numpy(a["wo"]),
            torch.from_numpy(a["g1"]), torch.from_numpy(a["b1"]),
            torch.from_numpy(a["res"]).reshape(B * F, H, T, T)]
    return [t.to(dtype) for t in args]


def test_kernels_refuse_what_they_do_not_take():
    args = _kernel_args()
    dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=True)
    with pytest.raises(ValueError, match="CUDA"):
        tat_fused.tat_forward_cuda(*args, **dims)
    with pytest.raises(TypeError, match="float32"):
        tat_fused.tat_forward_cuda(args[0].double(), *args[1:], **dims)
    with pytest.raises(ValueError, match="contiguous"):
        tat_fused.tat_forward_cuda(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                                   *args[1:], **dims)
    with pytest.raises(ValueError, match="wo must be"):
        tat_fused.tat_forward_cuda(*args[:5], args[5][:, :3], *args[6:], **dims)
    with pytest.raises(ValueError, match="CUDA"):
        tat_fused.tat_backward_cuda(*args, args[0], args[8], **dims)
    # one dtype for every tensor
    with pytest.raises(TypeError, match="one dtype"):
        tat_fused.tat_forward_cuda(*args[:4], args[4].bfloat16(), *args[5:], **dims)
    # the passes hold a tile of rows, not a row: float32 takes N = 2139 at
    # T = 48, which a row in one block did not
    assert tat_fused.smem_bytes(12, 170, 3, 32, 32, backward=True) < 227 * 1024
    assert tat_fused.smem_bytes(48, 2139, 2, 32, 32, backward=False) <= 227 * 1024


def test_cpu_path_counts_no_launch():
    before = (tat_fused.fwd_launches, tat_fused.bwd_launches)
    _port(_tensors(), True, False)
    assert (tat_fused.fwd_launches, tat_fused.bwd_launches) == before


def test_bfloat16_rounds_only_the_outputs():
    """In bfloat16 the function runs in float32 on the widened inputs and
    rounds out and scores once, as the TPU kernel does: equal, bit for bit,
    to the float32 function on the same (bf16-exact) values, rounded."""
    args = _kernel_args(torch.bfloat16)
    dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=True)
    o, s = tat_fused.tat_fused(*args, **dims)
    o32, s32 = tat_fused.tat_fused(*[t.float() for t in args], **dims)
    assert torch.equal(o, o32.bfloat16()) and torch.equal(s, s32.bfloat16())


# (T, N, H, d_k, d_v) that a float32 row in one block could not hold and
# the passes take: PEMS07 at T = 12, GAMBIA's block 2 (bench.py:222-236)
PEMS07 = (12, 883, 3, 32, 32)
GAMBIA = (144, 2139, 2, 32, 32)
SMEM_MAX = 227 * 1024


def _row_bytes(T, N, H, dk, dv, backward):
    """Shared memory of the float32 design the passes replaced, a B·F row
    in one block (its activations, float32): the shapes it admitted are the
    floor of what the float32 passes must admit."""
    W = H * (2 * dk + dv)
    if backward:
        return 4 * (5 * T * N + 2 * T * W + 2 * H * T * T + 2 * T * H * dv + 2 * T)
    return 4 * (2 * T * N + T * W + H * T * T + T * H * dv + T)


SHAPE_GRID = [(T, N, H, dk, dv) for T in (4, 6, 7, 12, 24, 48, 96, 144)
              for N in (20, 29, 170, 307, 358, 800, 883, 1200, 2139, 2905)
              for H, dk, dv in ((3, 32, 32), (2, 8, 8), (2, 32, 32), (8, 64, 64))]


@pytest.mark.parametrize("embed", [False, True], ids=["no_embed", "embed"])
def test_bf16_gate_admits_what_float32_admitted_and_more(embed):
    """Every shape (T >= 4, the model's T is 12 and up) whose float32 row
    fitted a block fits the bf16 passes, and so do PEMS07's N = 883 and
    GAMBIA's T = 144, which that row did not."""
    admitted = 0
    for T, N, H, dk, dv in SHAPE_GRID:
        if _row_bytes(T, N, H, dk, dv, backward=True) > SMEM_MAX:
            continue
        admitted += 1
        passes = tat_fused.passes(T, N, H, dk, dv, embed)
        assert all(rows > 0 for rows, _ in passes.values()), (T, N, H, dk, dv, passes)
    assert admitted > 50
    for shape in (PEMS07, GAMBIA):
        passes = tat_fused.passes(*shape, embed)
        assert all(rows > 0 and need <= SMEM_MAX for rows, need in passes.values()), passes
        for backward in (False, True):
            assert tat_fused.smem_bytes(*shape, backward=backward,
                                        dtype=torch.bfloat16, embed=embed) <= SMEM_MAX


@pytest.mark.parametrize("embed", [False, True], ids=["no_embed", "embed"])
def test_float32_gate_admits_every_shape_the_row_design_admitted(embed):
    """The float32 passes (wqkv's and wo's lo chunks staged beside the hi
    ones) admit, in both directions, every shape of the grid whose float32
    row fitted one block (``_row_bytes``, the formula of the design they
    replaced), and PEMS07 and GAMBIA besides."""
    admitted = 0
    for T, N, H, dk, dv in SHAPE_GRID:
        for backward in (False, True):
            if _row_bytes(T, N, H, dk, dv, backward) > SMEM_MAX:
                continue
            admitted += 1
            assert tat_fused.limit_error(T, N, H, dk, dv, torch.float32, backward,
                                         embed) is None, (T, N, H, dk, dv, backward)
    assert admitted > 100
    for shape in (PEMS07, GAMBIA):
        assert _row_bytes(*shape, backward=True) > SMEM_MAX
        passes = tat_fused.passes(*shape, embed, torch.float32)
        assert all(rows > 0 and need <= SMEM_MAX for rows, need in passes.values()), passes


def test_float32_gate_still_refuses():
    """What float32 refused it now admits: the one-block-a-row kernels are
    gone, and PEMS07's backward and GAMBIA's T = 144, whose rows did not fit
    a block, fit the passes; a CUDA call on CPU tensors raises for the
    device, after the gate, not for the bytes."""
    for shape in (PEMS07, GAMBIA):
        for backward in (False, True):
            assert tat_fused.limit_error(*shape, torch.float32, backward) is None
            assert tat_fused.smem_bytes(*shape, backward=backward) <= SMEM_MAX
    assert _row_bytes(*PEMS07, backward=True) > SMEM_MAX
    assert _row_bytes(*GAMBIA, backward=False) > SMEM_MAX
    x = torch.zeros((1, 12, 883))
    args = [x, torch.zeros(12, 883), torch.ones(883), torch.zeros(883),
            torch.zeros(883, 288), torch.zeros(96, 883), torch.ones(883), torch.zeros(883),
            torch.zeros(1, 3, 12, 12)]
    dims = dict(n_heads=3, d_k=32, d_v=32, embed=False)
    with pytest.raises(ValueError, match="CUDA"):
        tat_fused.tat_backward_cuda(*args, x, args[-1], **dims)


def test_bf16_gate_refuses_past_its_caps_naming_the_bytes():
    """The passes stream N in column chunks and T in query tiles and key
    chunks, so the old caps at PEMS08 widths (the LN1-backward pass at N =
    3328, the attention backward at T = 341) and the shapes past them are
    admitted in both dtypes and directions, each pass's bytes within a
    block's; a CUDA call on CPU tensors raises for the device, not for the
    bytes."""
    def args(T, N, dtype=torch.bfloat16):
        mk = lambda *s: torch.zeros(s, dtype=dtype)
        return [mk(1, T, N), mk(T, N), mk(N), mk(N), mk(N, 288), mk(96, N), mk(N), mk(N),
                mk(1, 3, T, T)]

    dims = dict(n_heads=3, d_k=32, d_v=32, embed=False)
    assert tat_fused.passes(12, 3328, 3, 32, 32)["ln1_bwd"][0] == 16
    assert tat_fused.passes(12, 3329, 3, 32, 32)["ln1_bwd"][0] == 16
    assert tat_fused.passes(341, 170, 3, 32, 32)["attn_bwd"] == (
        tat_fused.passes(342, 170, 3, 32, 32)["attn_bwd"])
    for T, N, which in ((12, 3329, "ln1_bwd"), (342, 170, "attn_bwd")):
        for dtype in (torch.bfloat16, torch.float32):
            plan = tat_fused.passes(T, N, 3, 32, 32, dtype=dtype)
            assert all(rows > 0 and need <= SMEM_MAX for rows, need in plan.values()), plan
            a = args(T, N, dtype)
            with pytest.raises(ValueError, match="CUDA"):
                tat_fused.tat_backward_cuda(*a, a[0], a[-1], **dims)
    with pytest.raises(ValueError, match="CUDA"):
        tat_fused.tat_forward_cuda(*args(12, 3329), **dims)


# (T, N) past the old caps: LargeST California's N = 8600 at T = 12, and
# two days and about three and a half of five-minute readings at N = 170
STREAMED = [(12, 8600), (576, 170), (1024, 170)]


@pytest.mark.parametrize("T, N", STREAMED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gate_admits_every_n_and_t(T, N, dtype):
    """limit_error is None in both directions, with and without the
    embedding: N-wide passes hold a column chunk of at most 1024 (N = 8600:
    nine of 960), the attention passes a key chunk of 32 and, past T = 160,
    a query tile of 32, so no block's bytes grow with N or T past those."""
    for embed in (False, True):
        for backward in (False, True):
            assert tat_fused.limit_error(T, N, 3, 32, 32, dtype, backward, embed) is None
        plan = tat_fused.passes(T, N, 3, 32, 32, embed, dtype)
        small = tat_fused.passes(12, 170, 3, 32, 32, embed, dtype)
        for name in ("attn_fwd", "attn_bwd"):
            assert plan[name][1] <= tat_fused.passes(32, 170, 3, 32, 32, embed, dtype)[name][1]
        for name in ("out", "ln1_bwd", "gte"):
            assert plan[name][1] <= tat_fused._pass_bytes(name, 64, 12, 1024, 3, 32, 32, embed,
                                                          dtype == torch.float32)
        assert plan["qkv"] == small["qkv"]
    assert tat_fused.column_chunk(8600) == (960, 9)
    assert tat_fused.column_chunk(170) == (176, 1) and tat_fused.column_chunk(1024) == (1024, 1)


def test_smem_bytes_follow_the_pass_formulas():
    """The bf16 gate's bytes are csrc/tat_fused.cu's smem16 formulas at the
    rows each pass takes (PEMS08 blocks 2-4: N = 170 → Np = 176 one column
    chunk, W = 288, H·d_v = 96, T = 12 one query tile and one key chunk;
    every pass's 64-row block lets two share an SM), and smem_bytes is the
    largest pass of a direction."""
    T, N, H, dk, dv = 12, 170, 3, 32, 32
    Np, Wp, hvp, LZ, KC, QT = 176, 288, 96, 180, 12, 12
    R = 64
    want = {
        "qkv": 2 * 64 * (Wp + 8) + 2 * R * 72 + 8 * R,
        "attn_fwd": 4 * (QT * 33 + KC * 33 + KC * 33 + QT * (KC + 1) + QT * dv + 2 * KC),
        "out": 4 * R * LZ + 4 * R * (hvp + 8) + 8 * R,
        "ln1_bwd": 4 * R * LZ + max(4 * R * (hvp + 8), 4 * R * 72 + 2 * hvp * 72) + 16 * R,
        "attn_bwd": 4 * (2 * QT * 33 + 2 * KC * 33 + 2 * QT * (KC + 1) + KC * dk + KC * dv
                         + 3 * KC),
        "gte": 4 * R * (Wp + 8) + 4 * 8 * 256,
    }
    passes = tat_fused.passes(T, N, H, dk, dv)
    assert {k: v[1] for k, v in passes.items()} == want
    assert {k: v[0] for k, v in passes.items()} == dict(
        qkv=64, attn_fwd=1, out=64, ln1_bwd=64, attn_bwd=1, gte=64)
    for backward, names in ((False, tat_fused.FWD_PASSES), (True, tat_fused.BWD_PASSES)):
        assert tat_fused.smem_bytes(T, N, H, dk, dv, backward, torch.bfloat16) == max(
            want[n] for n in names)
    # the embedding adds the qkv pass's lo chunk; the rows fall as the
    # column chunk grows (one chunk up to N = 1024; GAMBIA's 2139 in three
    # of 720), to the most whose block lets two share an SM
    assert tat_fused.passes(T, N, H, dk, dv, True)["qkv"][1] == want["qkv"] + 2 * R * 72
    assert tat_fused.passes(*PEMS07)["out"][0] == 16
    assert tat_fused.column_chunk(2139) == (720, 3)
    assert tat_fused.passes(*GAMBIA)["ln1_bwd"][0] == 32
    # float32: wqkv's lo chunk beside its hi chunk over half the columns
    # (144 at 64 rows), x split; wo's lo chunk in the LN1 backward
    f32 = tat_fused.passes(T, N, H, dk, dv, dtype=torch.float32)
    assert f32["qkv"] == (64, 2 * 64 * (144 + 8) * 2 + 2 * R * 72 * 2 + 8 * R)
    assert f32["ln1_bwd"] == (64, 4 * R * LZ + max(4 * R * (hvp + 8),
                                                   4 * R * 72 + 2 * hvp * 72 * 2) + 16 * R)
    assert all(f32[k] == passes[k] for k in ("attn_fwd", "out", "attn_bwd", "gte"))
    for backward, names in ((False, tat_fused.FWD_PASSES), (True, tat_fused.BWD_PASSES)):
        assert tat_fused.smem_bytes(T, N, H, dk, dv, backward) == max(
            f32[n][1] for n in names)


def test_bf16_cpu_call_takes_the_plain_version():
    """bf16 tensors on the CPU go to the plain version, gradients from
    autograd, and no kernel launch is counted."""
    args = _kernel_args(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in args]
    dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=False)
    before = (tat_fused.fwd_launches, tat_fused.bwd_launches)
    o, s = tat_fused.tat_fused(*leaves, **dims)
    want_o, want_s = tat_fused.tat_fused_plain(*args, **dims)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    _loss(o.float(), s.float(), torch).backward()
    assert leaves[0].grad is not None and leaves[0].grad.dtype == torch.bfloat16
    assert (tat_fused.fwd_launches, tat_fused.bwd_launches) == before


def _scaled_err(got, want):
    """max |Δ| over max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("embed", [True, False], ids=["embed", "no_embed"])
def test_nosplit_control_misses_the_split_limit(embed):
    """chip_smoke.py's split check holds the float32 passes within
    SPLIT_TOL of the plain float32 version; its control, the function with
    every product operand rounded to bf16 (``tat_nosplit_plain``), must miss
    that limit in the outputs and in the gradients, or the check could not
    tell a design without the lo terms apart. Run on the CPU at the
    tests' shape."""
    import chip_smoke

    dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=embed)
    runs = []
    for fn in (tat_fused.tat_fused_plain, chip_smoke.tat_nosplit_plain):
        leaves = [t.requires_grad_(True) for t in _kernel_args()]
        o, s = fn(*leaves, **dims)
        _loss(o, s, torch).backward()
        runs.append(([o.detach(), s.detach()], [t.grad for t in leaves]))
    (outs_p, grads_p), (outs_c, grads_c) = runs
    fwd = max(_scaled_err(c, p) for c, p in zip(outs_c, outs_p))
    bwd = max(_scaled_err(c, p) for c, p in zip(grads_c, grads_p) if p is not None)
    assert min(fwd, bwd) > chip_smoke.SPLIT_TOL


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for embed in (True, False):
        cpu = _kernel_args()
        leaves = [[t.cuda().requires_grad_(True) for t in cpu] for _ in range(2)]
        dims = dict(n_heads=H, d_k=DK, d_v=DV, embed=embed)
        before = (tat_fused.fwd_launches, tat_fused.bwd_launches)
        o, s = tat_fused.tat_fused(*leaves[0], **dims)
        o_p, s_p = tat_fused.tat_fused_plain(*leaves[1], **dims)
        _loss(o, s, torch).backward()
        _loss(o_p, s_p, torch).backward()
        torch.cuda.synchronize()
        assert (tat_fused.fwd_launches, tat_fused.bwd_launches) == (before[0] + 1,
                                                                     before[1] + 1)
        torch.testing.assert_close(o, o_p, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, s_p, atol=1e-4, rtol=1e-4)
        for k, p in zip(leaves[0], leaves[1]):
            # without the embedding, pos and LN0 are off the plain path
            want = p.grad if p.grad is not None else torch.zeros_like(p)
            torch.testing.assert_close(k.grad, want, atol=2e-3, rtol=2e-3)
        # the split check: the float32 passes (x and the weights split hi/lo)
        # against the plain float32 version within 1e-4 of scale (chip_smoke's
        # SPLIT_TOL), where the no-split control (every product operand
        # rounded to bf16) is not; the weight gradients bit for bit over two
        # launches
        import chip_smoke

        ctl = [t.detach().clone().requires_grad_(True) for t in leaves[1]]
        o_c, s_c = chip_smoke.tat_nosplit_plain(*ctl, **dims)
        _loss(o_c, s_c, torch).backward()
        err = lambda pairs: max(_scaled_err(a.detach(), b.detach()) for a, b in pairs)
        grads = lambda got: [(g.grad, p.grad) for g, p in zip(got, leaves[1])
                             if p.grad is not None]
        assert max(err([(o, o_p), (s, s_p)]), err(grads(leaves[0]))) <= chip_smoke.SPLIT_TOL
        assert min(err([(o_c, o_p), (s_c, s_p)]), err(grads(ctl))) > chip_smoke.SPLIT_TOL
        ops = tat_fused._operands(*[t.detach() for t in leaves[0]])
        g_out, g_sc = torch.randn_like(o), torch.randn_like(s)
        first, again = (tat_fused.tat_backward_cuda(*ops, g_out, g_sc, **dims)
                        for _ in range(2))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first[2:], again[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 40, 45, True), (2, 12, 2100, False), (2, 176, 30, False)],
                         ids=["t40_n45_embed", "n2100", "t176"])
def test_streamed_shapes_match_plain_on_card(shape):
    """The streamed branches on the card: several key chunks in one query
    tile (T = 40), several query tiles (T = 176), several column chunks of
    N (N = 2100: three of 704), with the embedding; float32 against the plain version within the
    split limit, bf16 within 1e-2 of scale, one launch a direction, the
    weight gradients bit for bit over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    BF, T_, N_, embed = shape
    rng = np.random.default_rng(5)
    W = 3 * 96
    mk = lambda *s, scale=1.0: torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))
    base = [mk(BF, T_, N_), mk(T_, N_, scale=0.3), 1 + mk(N_, scale=0.1), mk(N_, scale=0.1),
            mk(N_, W, scale=N_ ** -0.5), mk(96, N_, scale=96 ** -0.5), 1 + mk(N_, scale=0.1),
            mk(N_, scale=0.1), mk(BF, 3, T_, T_, scale=0.5)]
    cots = [mk(BF, T_, N_), mk(BF, 3, T_, T_, scale=0.1)]
    dims = dict(n_heads=3, d_k=32, d_v=32, embed=embed)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        ins = [t.to(dtype).cuda() for t in base]
        gs = [t.to(dtype).cuda() for t in cots]
        runs = []
        for fn in (lambda *a: tat_fused.TatFused.apply(*a, 3, 32, 32, embed),
                   lambda *a: tat_fused.tat_fused_plain(*a, **dims)):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            outs = fn(*leaves)
            grads = torch.autograd.grad(outs, leaves, gs, allow_unused=True)
            runs.append(([o.float() for o in outs],
                         [torch.zeros_like(x, dtype=torch.float32) if g is None else g.float()
                          for g, x in zip(grads, leaves)]))
        (ok, gk), (op, gp) = runs
        for got, want in zip(ok + gk, op + gp):
            assert _scaled_err(got, want) <= tol
        first, again = (tat_fused.tat_backward_cuda(*tat_fused._operands(*ins), *gs, **dims)
                        for _ in range(2))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first[2:], again[2:]))
