"""The BELL kernels at every width: their chunked schedules
(csrc/bell_fused.cu, csrc/bell_bwd.cu) emulated in torch with chunks forced
small so that every multi-chunk branch runs, held against the port's plain
versions and the JAX package's K1/K2 (``bell_bwd_dA_dtheta``,
``bell_bwd_dx``, c-major) in interpret mode; and the BELL gate's property:
it refuses exactly the dtypes, grids and int32 indices the kernels cannot
take, and every shape it admits has plans that fit a block.

The emulations repeat each kernel's order of work and its roundings: bf16
operands as they are, float32 ones and float32 sums split into bf16 hi +
lo where they meet a product (three products: hi·hi + hi·lo + lo·hi), sums
in float32. Tolerances: float32 within 1e-4 of scale (chip_smoke.py's
SPLIT_TOL), bf16 outputs differing from the plain version's on at most 1%
of their values (F_SPLIT_SHARE), JAX within 2e-4 (float32) of scale.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dstagnn_drought_tpu.ops import block_sparse as jbs
from dstagnn_drought_tpu.ops.pallas import bell_bwd as jbwd
from dstagnn_drought_tpu_torch.ops import block_sparse as tbs
from dstagnn_drought_tpu_torch.ops.cuda import bell_bwd, bell_fused

torch.set_num_threads(1)

SPLIT_TOL, SHARE = 1e-4, 1e-2


def _split(v):
    """A float32 tensor's bf16 hi and lo terms, as float32."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _mm(eq, a, b, f32_a=True, f32_b=True):
    """einsum(eq, a, b) as the kernels form it: one product of bf16-exact
    operands, two where one of them is a float32 value (its hi and lo), three
    where both are (hi·hi + hi·lo + lo·hi), summed in float32."""
    ah, al = _split(a) if f32_a else (a, None)
    bh, bl = _split(b) if f32_b else (b, None)
    out = torch.einsum(eq, ah, bh)
    if f32_b:
        out = out + torch.einsum(eq, ah, bl)
    if f32_a:
        out = out + torch.einsum(eq, al, bh)
    return out


def _share(got, want):
    """The share of values that differ."""
    return float((got.float() != want.float()).float().mean())


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.float().abs().max()))


def _operands(C, Co, dtype, seed=1, B=2, n=29, BS=8, H=2, T=16):
    """K1/K2 and forward operands in the c-major layout both packages share
    (the TPU c-major kernels need 128 | C·T and 128 | Co·T), w built as the
    backward builds it (softmax weights times Chebyshev values, in dtype)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) < 0.25).astype(np.float32)
    bell = tbs.block_ell_from_adjacency(A, block_size=BS)
    t = bell.tensors
    Np, An = bell.padded_nodes, bell.num_active
    rows = torch.from_numpy((np.arange(Np) < n)[None, :, None].astype(np.float32))
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k = f(B, Np, H, 8), f(B, Np, H, 8)
    pattern = t["active_pattern"][:, None]
    bias = torch.where(pattern, f(An, H, BS, BS), torch.tensor(-1e30)).contiguous()
    cheb = (f(An, H, BS, BS) * pattern).contiguous()
    x = (f(B, Np, C * T) * rows).to(dtype)
    gm = f(B, Np, Co * T)
    gm = (gm * (gm > -0.5) * rows).to(dtype)
    th = f(H, C, Co) * 0.1
    _, _, att = bell_fused.active_softmax(q, k, bias, t["active_src"], t["active_tgt"],
                                          bell.num_tiles)
    w = (cheb[None] * att * pattern[None]).to(dtype)
    return dict(A=A, bell=bell, q=q, k=k, bias=bias, cheb=cheb, x=x, gm=gm, th=th, w=w,
                T=T, dtype=dtype)


# ---------------------------------------------------------------------------
# the forward: channels in chunks, heads in groups, the Θ mix summed across
# them in float32, the ReLU after the last; scores over d_k in chunks
# ---------------------------------------------------------------------------

def f_emulated(o, CC, HG, relu_each=False):
    """f_spmm_wmma_kernel's schedule: for each (channel chunk, head group)
    agg = Σ_u w_uᵀ x_u (float32 sums; w and x split where float32), split
    into hi + lo and mixed by Θ's split into the output's float32 sums; the
    ReLU and the one cast after the last (``relu_each``: after every chunk,
    the control)."""
    bell, x, w, th, dtype = o["bell"], o["x"], o["w"], o["th"], o["dtype"]
    t = bell.tensors
    B, Np, M = x.shape
    H, C, Co = th.shape
    T, BS, NJ = M // C, bell.block_size, bell.num_tiles
    f32 = dtype == torch.float32
    xs = x.float().reshape(B, -1, BS, C, T)[:, t["active_src"].long()]
    out = torch.zeros(B, NJ, BS, Co, T)
    for c0 in range(0, C, CC):
        for h0 in range(0, H, HG):
            part = torch.zeros(B, NJ, HG, BS, min(CC, C - c0), T)
            contrib = _mm("bahst,bascu->bahtcu", w.float()[:, :, h0:h0 + HG],
                          xs[:, :, :, c0:c0 + CC], f32, f32)
            part.index_add_(1, t["active_tgt"].long(), contrib)
            out = out + _mm("bjhtcu,hco->bjtou", part, th[h0:h0 + HG, c0:c0 + CC])
            if relu_each:
                out = torch.relu(out)
    return torch.relu(out).reshape(B, NJ * BS, Co * T).to(dtype)


def _f_args(o):
    t = o["bell"].tensors
    return (t["tile_start"], t["tile_count"], t["active_src"], o["q"], o["k"], o["bias"],
            o["cheb"], o["x"], o["th"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_channel_chunks_match_plain(dtype):
    """The channel-chunked mix (chunks of 48 of 128 channels: a ragged last
    chunk; heads one a group) equals the plain forward: float32 within 1e-4
    of scale, bf16 on all but 1% of the outputs; a ReLU after every chunk
    (the control) does not."""
    o = _operands(128, 16, dtype)
    want = bell_fused.bell_forward_plain(*_f_args(o))
    got = f_emulated(o, CC=48, HG=1)
    control = f_emulated(o, CC=48, HG=1, relu_each=True)
    if dtype == torch.float32:
        assert _rel(got, want) <= SPLIT_TOL < _rel(control, want)
    else:
        assert _share(got, want) <= SHARE < _share(control, want)
    # one chunk and one group: the single-step path of the same kernel
    single = f_emulated(o, CC=128, HG=2)
    assert (_rel(single, want) <= SPLIT_TOL if dtype == torch.float32
            else _share(single, want) <= SHARE)


def test_scores_in_d_k_chunks_match_plain():
    """The weights pass's scores over d_k in chunks of 128 (kDC) at d_k =
    160, summed in chunk order, through the neighbourhood softmax (segment
    max and sum over each target tile's slots): the weights equal the plain
    version's to float32 rounding."""
    rng = np.random.default_rng(3)
    B, H, dk, BS, NJ = 2, 2, 160, 8, 2
    q = torch.from_numpy(rng.normal(size=(B, NJ * BS, H, dk)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, NJ * BS, H, dk)).astype(np.float32))
    src, tgt = torch.tensor([0, 1, 1]), torch.tensor([0, 0, 1])  # target-sorted
    bias = torch.from_numpy(rng.normal(size=(3, H, BS, BS)).astype(np.float32))
    _, _, att = bell_fused.active_softmax(q, k, bias, src, tgt, NJ)
    qa, ka = q.reshape(B, -1, BS, H, dk)[:, src], k.reshape(B, -1, BS, H, dk)[:, tgt]
    s = torch.zeros(B, 3, H, BS, BS)
    for d0 in range(0, dk, 128):
        s += torch.einsum("bashd,bathd->bahst", qa[..., d0:d0 + 128], ka[..., d0:d0 + 128])
    s = s / math.sqrt(dk) + bias[None]
    want = torch.empty_like(att)
    for j in range(NJ):
        sel = tgt == j
        e = torch.exp(s[:, sel] - s[:, sel].amax(dim=(1, 3), keepdim=True))
        want[:, sel] = e / e.sum(dim=(1, 3), keepdim=True)
    torch.testing.assert_close(att, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K1 and K2: g_agg over Co in chunks, rounded once; channels in chunks;
# source rows in tiles; dΘ from fixed-order partials
# ---------------------------------------------------------------------------

def g_agg_emulated(gm, th, T, OCC, f32, round_each=False):
    """g_agg (B, Np, H, C, T) as the kernels form it: Σ over chunks of OCC
    output channels of gm · Θ_hᵀ (Θ split; gm split where float32), summed in
    float32 (``round_each``, the control: rounded to bf16 after every
    chunk)."""
    B, Np, _ = gm.shape
    H, C, Co = th.shape
    g = gm.float().reshape(B, Np, Co, T)
    out = torch.zeros(B, Np, H, C, T)
    for o0 in range(0, Co, OCC):
        out = out + _mm("bnot,hco->bnhct", g[:, :, o0:o0 + OCC], th[:, :, o0:o0 + OCC], f32, True)
        if round_each:
            out = out.bfloat16().float()
    return out


def k1_emulated(o, CC, OCC, RS, TC, TG, round_each=False):
    """K1's schedule: dA per source-row tile of RS rows and channel chunk of
    CC, g_agg over Co in chunks of OCC rounded to the compute dtype once (the
    control: after every chunk); dΘ per (m-tile of 8 steps, target-row chunk
    of TC) from agg split hi + lo, partials per time group of TG chunks
    summed in a fixed order."""
    bell, x, w, gm, th, T, dtype = (o[k] for k in ("bell", "x", "w", "gm", "th", "T", "dtype"))
    t = bell.tensors
    B, A, H, BS, _ = w.shape
    C, Co = th.shape[1:]
    f32 = dtype == torch.float32
    src, tgt = t["active_src"].long(), t["active_tgt"].long()
    g = g_agg_emulated(gm, th, T, OCC, f32, round_each)
    g = g if f32 else g.to(dtype).float()
    g = g.reshape(B, -1, BS, H, C, T)[:, tgt]                    # (B, A, BS_t, H, C, T)
    xs = x.float().reshape(B, -1, BS, C, T)[:, src]              # (B, A, BS_s, C, T)
    dA = torch.zeros(B, A, H, BS, BS)
    for r0 in range(0, BS, RS):
        for c0 in range(0, C, CC):
            dA[:, :, :, r0:r0 + RS] += _mm("bascu,bathcu->bahst", xs[:, :, r0:r0 + RS, c0:c0 + CC],
                                          g[..., c0:c0 + CC, :], f32, f32)
    # dΘ: agg per (slot, head) over the time chunks of each group, in order
    gmt = gm.float().reshape(B, -1, BS, Co, T)[:, tgt]
    parts = []
    for g0 in range(0, T, 8 * TG):
        part = torch.zeros(H, C, Co)
        for ch in range(g0, min(T, g0 + 8 * TG), 8):
            agg = _mm("bahst,bascu->bahtcu", w.float(), xs[..., ch:ch + 8], f32, f32)
            for t1 in range(0, BS, TC):
                part += _mm("bahtcu,batou->hco", agg[:, :, :, t1:t1 + TC],
                            gmt[:, :, t1:t1 + TC, :, ch:ch + 8], True, f32)
        parts.append(part)
    return dA, sum(parts)


def k2_emulated(o, OCC, RS, TR):
    """K2's schedule: dx per source-row tile of RS rows over the tile's
    outgoing slots, TR target rows a step and every head, g over Co in
    chunks of OCC (float32 sums) split into hi + lo against w (split where
    float32), one cast at the end."""
    bell, w, gm, th, T, dtype = (o[k] for k in ("bell", "w", "gm", "th", "T", "dtype"))
    t = bell.tensors
    B, A, H, BS, _ = w.shape
    C = th.shape[1]
    f32 = dtype == torch.float32
    NI = t["src_count"].shape[0]
    g = g_agg_emulated(gm, th, T, OCC, f32).reshape(B, -1, BS, H, C * T)[:, t["active_tgt"].long()]
    a_src = torch.empty(A, dtype=torch.long)
    a_src[t["src_order"].long()] = torch.repeat_interleave(torch.arange(NI),
                                                           t["src_count"].long())
    dx = torch.zeros(B, NI, BS, C * T)
    for r0 in range(0, BS, RS):
        for t1 in range(0, BS, TR):
            contrib = _mm("bahst,bathm->basm", w.float()[:, :, :, r0:r0 + RS, t1:t1 + TR],
                          g[:, :, t1:t1 + TR], f32, True)
            dx[:, :, r0:r0 + RS].index_add_(1, a_src, contrib)
    return dx.reshape(B, NI * BS, C * T).to(dtype)


def _k1_args(o):
    t = o["bell"].tensors
    return (t["active_src"], t["active_tgt"], o["th"], o["gm"], o["x"], o["w"])


def _k2_args(o):
    t = o["bell"].tensors
    return (t["src_start"], t["src_count"], t["src_order"], t["active_tgt"], o["th"], o["gm"],
            o["w"])


def _jax_k1_k2(o):
    """JAX's c-major K1 (dA, dΘ) and K2 (dx) on the same operands, interpret."""
    bell, C = o["bell"], o["th"].shape[1]
    S = bell.max_blocks
    jb = jbs.block_ell_from_adjacency(o["A"], block_size=bell.block_size)
    j = lambda v: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if o["dtype"] == torch.bfloat16 else jnp.float32)
    w_pad = jnp.pad(j(o["w"]), ((0, 0), (0, S), (0, 0), (0, 0), (0, 0)))
    dA, dth = jbwd.bell_bwd_dA_dtheta(
        jb.tile_start, jb.tile_count, jnp.pad(jb.active_src, (0, S)), jnp.asarray(o["th"].numpy()),
        j(o["gm"]), j(o["x"]), w_pad, S_max=S, n_ch=C, interpret=True, layout="c")
    dx = jbwd.bell_bwd_dx(
        jb.src_start, jb.src_count, jnp.pad(jb.active_tgt[jb.src_order], (0, S)),
        jnp.pad(jb.src_order, (0, S)), jnp.asarray(o["th"].numpy()), j(o["gm"]), w_pad,
        max_out=bell.max_src_blocks, n_ch=C, np_src=bell.padded_nodes, interpret=True,
        layout="c")
    to = lambda v: torch.from_numpy(np.array(v.astype(jnp.float32)))
    return to(dA)[:, :bell.num_active], to(dth), to(dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_chunked_schedules_match_plain_and_jax(dtype):
    """At C = 128 on the 29-node graph (BS = 8, T = 16, Co = 8), K1 and K2
    with every chunk forced small (channels 48 of 128, output channels 3 of
    8, source rows 4 of 8, target rows 4, time groups of 1 chunk): dA, dΘ
    and dx against the plain versions (float32 within 1e-4 of scale; bf16
    dA within 1e-2 of scale, dΘ within 1e-4 of the plain float32 dΘ, dx on
    all but 1% of its values) and against JAX's K1 and K2 in interpret mode
    (float32 within 2e-4 of scale, bf16 1e-2)."""
    o = _operands(128, 8, dtype)
    dA, dth = k1_emulated(o, CC=48, OCC=3, RS=4, TC=4, TG=1)
    dx = k2_emulated(o, OCC=3, RS=4, TR=4)
    dA_p, dth_p = bell_bwd.bell_k1_plain(*_k1_args(o))
    dx_p = bell_bwd.bell_k2_plain(*_k2_args(o))
    if dtype == torch.float32:
        assert max(_rel(dA, dA_p), _rel(dth, dth_p), _rel(dx, dx_p)) <= SPLIT_TOL
    else:
        assert _rel(dA, dA_p) <= 1e-2 and _rel(dth, dth_p) <= SPLIT_TOL
        assert _share(dx, dx_p) <= SHARE
    j_dA, j_dth, j_dx = _jax_k1_k2(o)
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    assert max(_rel(dA, j_dA), _rel(dth, j_dth), _rel(dx, j_dx)) <= tol
    # time groups of two chunks: the same dΘ up to the order of the sums
    assert _rel(k1_emulated(o, CC=48, OCC=3, RS=4, TC=4, TG=2)[1], dth_p) <= SPLIT_TOL


def test_g_agg_rounded_once_not_per_chunk():
    """In bf16, g_agg is rounded to bf16 once, after the whole sum over Co
    (the TPU kernel's cast): the kernels' Co-chunked sum rounded once gives
    the plain version's rounded g_agg on all but 1% of its values (0.14%
    here), where rounding after every chunk of Co (a different function)
    misses it (29%)."""
    o = _operands(128, 8, torch.bfloat16)
    want = bell_bwd._g_agg(o["gm"], o["th"], o["T"]).to(torch.bfloat16)
    B, Np = o["gm"].shape[:2]
    once = g_agg_emulated(o["gm"], o["th"], o["T"], 3, False).reshape(B, Np, 2, -1)
    each = g_agg_emulated(o["gm"], o["th"], o["T"], 3, False, round_each=True).reshape(B, Np, 2, -1)
    assert _share(once.to(torch.bfloat16), want) <= SHARE < _share(each.to(torch.bfloat16), want)
    dA_p, _ = bell_bwd.bell_k1_plain(*_k1_args(o))
    dA_once = k1_emulated(o, CC=48, OCC=3, RS=4, TC=4, TG=1)[0]
    dA_each = k1_emulated(o, CC=48, OCC=3, RS=4, TC=4, TG=1, round_each=True)[0]
    # dA moves with it: a few rounding ties of g_agg fall the other way in
    # the chunked sum (about 1.5e-4 of scale), every chunk's rounding ~2e-3
    assert _rel(dA_once, dA_p) <= 5e-4 < _rel(dA_each, dA_p)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

# mostly the sizes models take, sometimes past CUDA's grid limits
SHAPES = dict(B=st.one_of(st.integers(1, 64), st.integers(1, 70000)),
              H=st.one_of(st.integers(1, 8), st.integers(1, 70000)), BS=st.integers(1, 300),
              dk=st.integers(1, 600), C=st.integers(1, 300), T=st.integers(1, 300),
              Co=st.integers(1, 2100),
              dtype=st.sampled_from([torch.float32, torch.bfloat16, torch.float16]))


@settings(max_examples=200, deadline=None)
@given(**SHAPES)
def test_gate_refuses_exactly_what_the_kernels_refuse(B, H, BS, dk, C, T, Co, dtype):
    """bell_fused.limit_error, the Trainer's BELL gate and the one shape
    function the three kernels' wrappers raise at launch, refuses a shape
    exactly where the dtype is not float32 or bf16, CUDA's grid limits on
    B, H and B·H are passed or a dΘ row is past int32 indices, never for a
    block size, d_k or T; every shape it admits has a plan for F, K1
    and K2 that fits a block, so the kernels launch at every (C, Co, BS,
    d_k, T) JAX's wrappers take."""
    gate = bell_fused.limit_error(B, H, C, Co, dtype)
    bad_dtype = dtype not in (torch.float32, torch.bfloat16)
    bad_grid = max(B, H, B * H) > 65535
    bad_index = H * (-(-C // 16) * 16) * (-(-Co // 16) * 16) * 16 > 2**31 - 1
    assert (gate is None) == (not (bad_dtype or bad_grid or bad_index))
    if gate is not None:
        assert ("float32 or bfloat16" in gate) == bad_dtype
        assert "grid too large" in gate or "int32" in gate or bad_dtype
        return
    assert bell_fused.f_plan(BS, C, Co, T, H, dtype)["smem"] <= 232448
    assert max(bell_bwd.k1_plan(BS, C, Co, T, dtype)["smem"]) <= 232448
    assert bell_bwd.k2_plan(BS, C, Co, T, dtype)["smem"] <= 232448
    assert bell_fused.f_weights_smem_bytes(dk) <= 232448
