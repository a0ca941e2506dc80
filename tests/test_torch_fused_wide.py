"""The fused TAt and the fused spatial middle at every head and channel
width: their chunked schedules (csrc/tat_fused.cu, csrc/block_spatial_fused.cu)
emulated in torch with the chunks forced small so that every multi-chunk
branch runs, held against the port's plain versions and the JAX package's
``fused_temporal_attention`` and ``fused_spatial_middle`` (Pallas, interpret
mode on the CPU) on the same numpy-seeded inputs and weights; the two gates'
property (they refuse exactly CUDA's grid and int32 limits, and every shape
they admit has plans within a block); and the Trainer's card check at build
(``check_fused_shapes``) on the two CLI projects of chip_smoke.py.

The emulations repeat each kernel's order of work: the TAt's attention on
both routes (every query in one tile; query tiles with d_k and d_v staged a
head chunk at a time, ctx, g_k and g_v summed chunk by chunk), its N-wide
passes with their K operand in chunks (ctx in the out and LN1-backward
passes, g_qkv in the g_te pass) and g_ctx in column groups; the spatial
middle's C and Co in chunks (the Θ mix summed over C chunks in order, Co
chunks across blocks, dagg's sums over Co chunks), d in chunks (the
embedding's LayerNorm statistics merged by Chan's formula, SD's row sums
over chunks) and the SAt's d_k in chunks (each score's chain continued
chunk by chunk, the dk partials summed in place). Sums are float32.
Tolerances: forward 2e-4, gradients 5e-3, bf16 1e-2, of each tensor's scale.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dstagnn_drought_tpu.ops.pallas import block_spatial_fused as jbsf
from dstagnn_drought_tpu.ops.pallas.tat_fused import fused_temporal_attention as jax_tat
from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.models.dstagnn import ModelSpec
from dstagnn_drought_tpu_torch.ops.cuda import block_spatial_fused as bsf
from dstagnn_drought_tpu_torch.ops.cuda import tat_fused
from dstagnn_drought_tpu_torch.training import loop

torch.set_num_threads(1)

EPS = 1e-5
FWD_TOL, GRAD_TOL, BF16_TOL = 2e-4, 5e-3, 1e-2
SMEM_MAX = 232448


def _close(got, want, tol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: {err:.3g} of scale > {tol}"


def _spans(n, w):
    """(start, width) of n columns in chunks of w, the last ragged."""
    return [(c0, min(w, n - c0)) for c0 in range(0, n, w)]


def _merge(zc, n, stats):
    """Chan's merge of a chunk's columns zc (rows, cv) into the running
    (mean, m2) over the first n columns (dense::merge_row)."""
    cv = zc.shape[1]
    mc = zc.sum(1) / cv
    v = ((zc - mc[:, None]) ** 2).sum(1)
    if n == 0:
        return mc, v
    mean, m2 = stats
    delta, nn = mc - mean, float(n + cv)
    return mean + delta * (cv / nn), m2 + v + delta * delta * (n * cv / nn)


# ---------------------------------------------------------------------------
# the fused TAt
# ---------------------------------------------------------------------------

TB, TF, TN, TH, TDK, TDV = 2, 2, 29, 2, 40, 40
# forced small: N's column chunks, the key chunk, the chunked route's query
# tile and head chunk, the split passes' ctx and g_qkv chunks and g_ctx group
NC, KC, QT, HCH, HVC, GC, WC = 16, 8, 8, 16, 32, 48, 64


def _tat_arrays(T, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=0.3: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        x=mk(TB, TF, T, TN, scale=1.0), pos=mk(T, TN), g0=1 + mk(TN, scale=0.1),
        b0=mk(TN, scale=0.1), wq=mk(TN, TH * TDK), wk=mk(TN, TH * TDK), wv=mk(TN, TH * TDV),
        wo=mk(TH * TDV, TN), g1=1 + mk(TN, scale=0.1), b1=mk(TN, scale=0.1),
        res=mk(TB, TF, TH, T, T, scale=0.5), g_out=mk(TB, TF, T, TN, scale=1.0),
        g_sc=mk(TB, TF, TH, T, T, scale=0.1))


TAT_NAMES = ("x", "pos", "g0", "b0", "wq", "wk", "wv", "wo", "g1", "b1", "res")


def _jax_tat(a, embed):
    def f(x, pos, g0, b0, wq, wk, wv, wo, g1, b1, res):
        return jax_tat(x, res, pos=pos if embed else None, ln0_scale=g0 if embed else None,
                       ln0_bias=b0 if embed else None, wq=wq, wk=wk, wv=wv, wo=wo,
                       ln_scale=g1, ln_bias=b1, n_heads=TH, d_k=TDK, d_v=TDV)

    (out, sc), vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a[n]) for n in TAT_NAMES))
    grads = vjp((jnp.asarray(a["g_out"]), jnp.asarray(a["g_sc"])))
    return np.asarray(out), np.asarray(sc), dict(zip(TAT_NAMES, (np.asarray(g) for g in grads)))


def _plain_tat(a, embed, dtype=torch.float32):
    """The port's plain version (the wrapper on CPU tensors), gradients from
    autograd, in ``dtype``."""
    t = {n: torch.from_numpy(a[n]).to(dtype).requires_grad_(True) for n in TAT_NAMES}
    out, sc = tat_fused.fused_temporal_attention(
        t["x"], t["res"], pos=t["pos"] if embed else None, ln0_scale=t["g0"] if embed else None,
        ln0_bias=t["b0"] if embed else None, wq=t["wq"], wk=t["wk"], wv=t["wv"], wo=t["wo"],
        ln_scale=t["g1"], ln_bias=t["b1"], n_heads=TH, d_k=TDK, d_v=TDV)
    torch.autograd.backward((out, sc), (torch.from_numpy(a["g_out"]).to(dtype),
                                        torch.from_numpy(a["g_sc"]).to(dtype)))
    zero = lambda v: torch.zeros_like(v) if v.grad is None else v.grad
    return out.detach(), sc.detach(), {n: zero(v).float() for n, v in t.items()}


def _wide_tat(a, embed, route):
    """The kernels' passes 1-7 on the (B·F·T, N) rows with the wide
    schedules, forward and backward: the attention on ``route`` (``one``:
    every query in one tile, each key chunk's column softmax complete in the
    chunk and its share of ctx added at once, the whole head staged;
    ``chunk``: query tiles of QT, d_k and d_v staged HCH columns at a time,
    ctx, g_v, g_k and g_q summed in place chunk by chunk), the out and
    LN1-backward passes with ctx in chunks of HVC (each chunk's product
    continuing the last one's sums), g_ctx in column groups of GC, the g_te
    pass with g_qkv in chunks of WC; N in column chunks of NC throughout.
    Returns (out, scores, grads)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    T = t["x"].shape[2]
    BF, M = TB * TF, TB * TF * T
    x = t["x"].reshape(M, TN)
    pos = t["pos"].repeat(BF, 1)
    wqkv = torch.cat([t["wq"], t["wk"], t["wv"]], 1)
    wo, g0, b0, g1, b1 = t["wo"], t["g0"], t["b0"], t["g1"], t["b1"]
    res = t["res"].reshape(BF, TH, T, T)
    g_out, g_sc = t["g_out"].reshape(M, TN), t["g_sc"].reshape(BF, TH, T, T)
    hk, hv, W = TH * TDK, TH * TDV, TH * (2 * TDK + TDV)
    inv_sqrt = 1.0 / math.sqrt(TDK)
    chunks = _spans(TN, NC)
    # pass 1
    if embed:
        zx = x + pos
        mu0 = zx.mean(1, keepdim=True)
        inv0 = torch.rsqrt(((zx - mu0) ** 2).mean(1, keepdim=True) + EPS)
        xh0 = (zx - mu0) * inv0
        te = xh0 * g0 + b0
    else:
        te = x
    qkv = te @ wqkv
    heads = lambda c0, d: qkv[:, c0:c0 + TH * d].reshape(BF, T, TH, d).permute(0, 2, 1, 3)
    q, k, v = heads(0, TDK), heads(hk, TDK), heads(2 * hk, TDV)
    one = route == "one"
    dk_chunks = [(0, TDK)] if one else _spans(TDK, HCH)
    dv_chunks = [(0, TDV)] if one else _spans(TDV, HCH)
    q_tiles, k_chunks = _spans(T, T if one else QT), _spans(T, KC)

    def score(q0, qn, k0, kn):  # the chain over d_k continued chunk by chunk
        s = torch.zeros(BF, TH, qn, kn)
        for c0, cw in dk_chunks:
            s = s + q[:, :, q0:q0 + qn, c0:c0 + cw] @ k[:, :, k0:k0 + kn, c0:c0 + cw].transpose(
                -1, -2)
        return s * inv_sqrt + res[:, :, q0:q0 + qn, k0:k0 + kn]

    # pass 2
    scores = torch.empty(BF, TH, T, T)
    cmax, csum = torch.empty(BF, TH, T), torch.empty(BF, TH, T)
    ctx = torch.zeros(BF, TH, T, TDV)
    for k0, kn in k_chunks:
        m = torch.full((BF, TH, kn), -math.inf)
        l = torch.zeros_like(m)
        for q0, qn in q_tiles:
            s = score(q0, qn, k0, kn)
            scores[:, :, q0:q0 + qn, k0:k0 + kn] = s
            m_new = torch.maximum(m, s.max(2).values)
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, :, None]).sum(2)
            m = m_new
            if one:  # the column is complete in its one tile
                ctx += torch.exp(s - m[:, :, None]) / l[:, :, None] @ v[:, :, k0:k0 + kn]
        cmax[:, :, k0:k0 + kn], csum[:, :, k0:k0 + kn] = m, l

    def attn(q0, qn, k0, kn):
        s = score(q0, qn, k0, kn)
        return torch.exp(s - cmax[:, :, None, k0:k0 + kn]) / csum[:, :, None, k0:k0 + kn]

    if not one:  # ctx a query tile at a time, v a head chunk at a time
        for q0, qn in q_tiles:
            for k0, kn in k_chunks:
                a_t = attn(q0, qn, k0, kn)
                for c0, cw in dv_chunks:
                    ctx[:, :, q0:q0 + qn, c0:c0 + cw] += a_t @ v[:, :, k0:k0 + kn, c0:c0 + cw]
    ctx = ctx.permute(0, 2, 1, 3).reshape(M, hv)

    # pass 3: z a column chunk at a time, ctx in chunks of HVC
    def z_chunk(c0, cv):
        z = torch.zeros(M, cv)
        for h0, hn in _spans(hv, HVC):
            z = z + ctx[:, h0:h0 + hn] @ wo[h0:h0 + hn, c0:c0 + cv]
        return z + te[:, c0:c0 + cv]

    stats = None
    zbuf = torch.zeros(M, TN)
    for c0, cv in chunks:
        zbuf[:, c0:c0 + cv] = z_chunk(c0, cv)
        stats = _merge(zbuf[:, c0:c0 + cv], c0, stats)
    mean, m2 = stats
    inv1 = torch.rsqrt(m2 / TN + EPS)[:, None]
    out = (zbuf - mean[:, None]) * inv1 * g1 + b1
    # pass 4: LN1 backward a chunk at a time, then g_ctx a column group of GC at a time
    s1, s2 = torch.zeros(M), torch.zeros(M)
    xh1 = torch.empty(M, TN)
    for c0, cv in chunks:
        xh1[:, c0:c0 + cv] = (z_chunk(c0, cv) - mean[:, None]) * inv1
        gg = g_out[:, c0:c0 + cv] * g1[c0:c0 + cv]
        s1, s2 = s1 + gg.sum(1), s2 + (gg * xh1[:, c0:c0 + cv]).sum(1)
    gy = inv1 * (g_out * g1 - (s1 / TN)[:, None] - xh1 * (s2 / TN)[:, None])
    gctx = torch.empty(M, hv)
    for g0_, gn in _spans(hv, GC):
        gctx[:, g0_:g0_ + gn] = gy @ wo[g0_:g0_ + gn].t()
    gctx = gctx.reshape(BF, T, TH, TDV).permute(0, 2, 1, 3)
    # pass 5: a key chunk at a time, g_ctx and v a head chunk at a time for
    # g_a and g_v, q and k a head chunk at a time for g_k and g_q
    dres = torch.empty(BF, TH, T, T)
    gq, gk, gv = (torch.zeros(BF, TH, T, TDK), torch.zeros(BF, TH, T, TDK),
                  torch.zeros(BF, TH, T, TDV))

    def g_a(q0, qn, k0, kn, a_t=None):
        ga = torch.zeros(BF, TH, qn, kn)
        for c0, cw in dv_chunks:
            gc = gctx[:, :, q0:q0 + qn, c0:c0 + cw]
            ga = ga + gc @ v[:, :, k0:k0 + kn, c0:c0 + cw].transpose(-1, -2)
            if a_t is not None:
                gv[:, :, k0:k0 + kn, c0:c0 + cw] += a_t.transpose(-1, -2) @ gc
        return ga

    for k0, kn in k_chunks:
        delta = torch.zeros(BF, TH, kn)
        for q0, qn in q_tiles:
            a_t = attn(q0, qn, k0, kn)
            delta = delta + (a_t * g_a(q0, qn, k0, kn, a_t)).sum(2)
        for q0, qn in q_tiles:
            a_t = attn(q0, qn, k0, kn)
            ds = a_t * (g_a(q0, qn, k0, kn) - delta[:, :, None]) \
                + g_sc[:, :, q0:q0 + qn, k0:k0 + kn]
            dres[:, :, q0:q0 + qn, k0:k0 + kn] = ds
            for c0, cw in dk_chunks:
                gk[:, :, k0:k0 + kn, c0:c0 + cw] += ds.transpose(-1, -2) @ q[:, :, q0:q0 + qn,
                                                                             c0:c0 + cw]
                gq[:, :, q0:q0 + qn, c0:c0 + cw] += (ds @ k[:, :, k0:k0 + kn, c0:c0 + cw]) \
                    * inv_sqrt
    gk = gk * inv_sqrt
    rows = lambda g: g.permute(0, 2, 1, 3).reshape(M, -1)
    gqkv = torch.cat([rows(gq), rows(gk), rows(gv)], 1)
    # pass 6: g_te a column chunk at a time, g_qkv in chunks of WC
    gte = torch.empty(M, TN)
    for c0, cv in chunks:
        z = torch.zeros(M, cv)
        for w0, wn in _spans(W, WC):
            z = z + gqkv[:, w0:w0 + wn] @ wqkv[c0:c0 + cv, w0:w0 + wn].t()
        gte[:, c0:c0 + cv] = z + gy[:, c0:c0 + cv]
    grads = {}
    if embed:
        s1, s2 = torch.zeros(M), torch.zeros(M)
        for c0, cv in chunks:
            gg = gte[:, c0:c0 + cv] * g0[c0:c0 + cv]
            s1, s2 = s1 + gg.sum(1), s2 + (gg * xh0[:, c0:c0 + cv]).sum(1)
        dx = inv0 * (gte * g0 - (s1 / TN)[:, None] - xh0 * (s2 / TN)[:, None])
        grads.update(pos=dx.reshape(BF, T, TN).sum(0), g0=(gte * xh0).sum(0), b0=gte.sum(0))
    else:
        dx = gte
        grads.update(pos=torch.zeros(T, TN), g0=torch.zeros(TN), b0=torch.zeros(TN))
    # pass 7
    dwqkv = te.t() @ gqkv
    grads.update(x=dx.reshape(TB, TF, T, TN), wq=dwqkv[:, :hk], wk=dwqkv[:, hk:2 * hk],
                 wv=dwqkv[:, 2 * hk:], wo=ctx.t() @ gy, g1=(g_out * xh1).sum(0),
                 b1=g_out.sum(0), res=dres.reshape(TB, TF, TH, T, T))
    return out.reshape(TB, TF, T, TN), scores.reshape(TB, TF, TH, T, T), grads


# (T, route, embed): T = 12 on the one-tile route (key chunks of 8 and 4),
# T = 20 on the chunked route (query tiles and key chunks of 8, 8, 4; d_k and
# d_v in head chunks of 16, 16, 8), each with and without the embedding
TAT_CASES = [(12, "one", False), (12, "one", True), (20, "chunk", False), (20, "chunk", True)]


@pytest.mark.parametrize("T, route, embed", TAT_CASES)
def test_wide_tat_schedule_matches_plain_and_jax(T, route, embed):
    """N = 29 in column chunks of 16, 2 heads of d_k = d_v = 40, H·d_v = 80
    in ctx chunks of 32 and g_ctx groups of 48, W = 240 in g_qkv chunks of
    64: every multi-chunk branch of the head-chunked passes runs. Forward
    and every gradient against the port's plain version and JAX's kernel."""
    assert len(_spans(TN, NC)) == 2 and len(_spans(TDK, HCH)) == 3
    assert len(_spans(TH * TDV, HVC)) == 3 and len(_spans(TH * TDV, GC)) == 2
    a = _tat_arrays(T, T + embed)
    out, sc, grads = _wide_tat(a, embed, route)
    p_out, p_sc, p_grads = _plain_tat(a, embed)
    j_out, j_sc, j_grads = _jax_tat(a, embed)
    for name, (want_out, want_sc, want) in (("plain", (p_out, p_sc, p_grads)),
                                            ("jax", (j_out, j_sc, j_grads))):
        _close(out, want_out, FWD_TOL, f"{name} out")
        _close(sc, want_sc, FWD_TOL, f"{name} scores")
        for n in TAT_NAMES:
            if embed or n not in ("pos", "g0", "b0"):
                _close(grads[n], want[n], GRAD_TOL, f"{name} d{n}")


def test_wide_tat_schedule_in_bfloat16():
    """bf16 inputs: the passes compute in float32 on the bf16-exact values
    and round out, scores, dx and dres once; the chunked route's schedule
    on the bf16-rounded inputs, rounded likewise, against the plain version
    in bf16 within 1e-2 of scale."""
    a = _tat_arrays(20, 5)
    a16 = {k: torch.from_numpy(v).bfloat16().float().numpy() for k, v in a.items()}
    out, sc, grads = _wide_tat(a16, True, "chunk")
    p_out, p_sc, p_grads = _plain_tat(a16, True, torch.bfloat16)
    _close(out.bfloat16().float(), p_out.float(), BF16_TOL, "out")
    _close(sc.bfloat16().float(), p_sc.float(), BF16_TOL, "scores")
    for n in ("x", "res", "wq", "wo", "g1", "pos"):
        _close(grads[n].bfloat16().float(), p_grads[n], BF16_TOL, f"d{n}")


# ---------------------------------------------------------------------------
# the fused spatial middle
# ---------------------------------------------------------------------------

SB, SN, SF, ST, SC, SCO, SD, SK, SDK = 2, 29, 2, 4, 40, 40, 40, 2, 24
# forced small: a chunk's most columns (384 on the card), d's chunk, the
# SAt d_k's chunk, SD's 2·K·d_k chunk, the target tile and source step
CHUNK_COLS, DC, DKC, HC, TILE, STEP = 16, 16, 8, 32, 16, 16


def _channel_spans(C):
    """C in the fewest chunks of at most CHUNK_COLS, balanced (csrc
    channel_chunks)."""
    n = -(-C // CHUNK_COLS)
    return _spans(C, -(-C // n))


def _time_spans(T, C, Co):
    """The time chunks: the most steps whose Cc·Tc and Coc·Tc columns fit
    CHUNK_COLS, balanced (csrc time_chunks)."""
    w = max(_channel_spans(C)[0][1], _channel_spans(Co)[0][1])
    most = max(1, min(T, CHUNK_COLS // w))
    n = -(-T // most)
    return _spans(T, -(-T // n))


def _sp_arrays(seed=3):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    a = dict(tat=mk(SB, SF, ST, SN), x=mk(SB, SN, SC, ST), pre_w=mk(SD, ST, 1, SF),
             pre_b=mk(SD), pos=mk(SN, SD), gs=np.full(SD, 1.05, np.float32),
             bs=np.full(SD, 0.02, np.float32), wq=mk(SD, SK * SDK), wk=mk(SD, SK * SDK),
             masks=mk(SK, SN, SN), thetas=mk(SK, SC, SCO))
    adj = (rng.random((SN, SN)) < 0.3).astype(np.float32)
    return a, adj, mk(SK, SN, SN), rng.normal(size=(SB, SN, SCO, ST)).astype(np.float32)


def _sp_kw(t, adj, cheb):
    return dict(pre_w=t["pre_w"], pre_b=t["pre_b"], pos=t["pos"], ln_scale=t["gs"],
                ln_bias=t["bs"], wq=t["wq"], wk=t["wk"], adj_pa=adj, masks=t["masks"],
                cheb_polys=cheb, thetas=t["thetas"], K=SK, d_k=SDK)


def _wide_forward(tat, xm, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, md):
    """The forward kernels with every width chunked: SA (x_tat's columns in
    chunks of DC, the rows' LayerNorm statistics merged over the chunks,
    then each chunk again: semx and its share of qk), the column
    statistics (targets in tiles, sources streamed, the scores' chain over
    d_k continued a chunk at a time), and the column pass by (target tile,
    time chunk, Co chunk): for each k and C chunk in order agg = md(A)ᵀ
    md(xm) over the streamed sources, its Θ mix added. ``md`` rounds where
    the kernels cast to the matmul dtype. Returns (y, the intermediates)."""
    B, N, _ = tat.shape
    d, C = pw.shape[1], thetas.shape[1]
    Co, K = thetas.shape[2], bias.shape[0]
    T = xm.shape[-1] // C
    dk, hk = wqk.shape[1] // (2 * K), wqk.shape[1] // 2
    inv_dk = 1.0 / math.sqrt(dk)
    rows = tat.reshape(B * N, -1)
    posr = pos.repeat(B, 1)
    x_tat = lambda c0, cn: md(rows) @ pw[:, c0:c0 + cn] + pb[c0:c0 + cn] + posr[:, c0:c0 + cn]
    stats = None
    for c0, cn in _spans(d, DC):
        stats = _merge(x_tat(c0, cn), c0, stats)
    mu, m2 = stats
    inv = torch.rsqrt(m2 / d + EPS)[:, None]
    xhat, semx = torch.empty(B * N, d), torch.empty(B * N, d)
    qk = torch.zeros(B * N, wqk.shape[1])
    for c0, cn in _spans(d, DC):
        xhat[:, c0:c0 + cn] = (x_tat(c0, cn) - mu[:, None]) * inv
        semx[:, c0:c0 + cn] = md(xhat[:, c0:c0 + cn] * gs[c0:c0 + cn] + bs[c0:c0 + cn])
        qk = qk + semx[:, c0:c0 + cn] @ wqk[c0:c0 + cn]
    qk = qk.reshape(B, N, -1)
    tiles, steps = _spans(N, TILE), _spans(N, STEP)

    def score(b, k, i0, ni, j0, nj):
        s = torch.zeros(ni, nj)
        for c0, cw in _spans(dk, DKC):
            qc = md(qk[b, i0:i0 + ni, k * dk + c0:k * dk + c0 + cw])
            kc = md(qk[b, j0:j0 + nj, hk + k * dk + c0:hk + k * dk + c0 + cw])
            s = s + qc @ kc.T
        return s * inv_dk + bias[k, i0:i0 + ni, j0:j0 + nj]

    cstat = torch.zeros(B, K, N, 2)
    for b in range(B):
        for k in range(K):
            for j0, nj in tiles:
                m, l = torch.full((nj,), -math.inf), torch.zeros(nj)
                for i0, ni in steps:
                    s = score(b, k, i0, ni, j0, nj)
                    mt = torch.maximum(m, s.max(0).values)
                    l = l * torch.exp(m - mt) + torch.exp(s - mt).sum(0)
                    m = mt
                cstat[b, k, j0:j0 + nj] = torch.stack([m, l], -1)

    def att(b, k, i0, ni, j0, nj):
        st_ = cstat[b, k, j0:j0 + nj]
        return torch.exp(score(b, k, i0, ni, j0, nj) - st_[:, 0]) / st_[:, 1]

    x4 = md(xm).reshape(B, N, C, T)

    def aggregate(b, k, j0, nj, c0, cn, t0, tc):
        agg = torch.zeros(nj, cn, tc)
        for i0, ni in steps:
            A = md(cheb[k, i0:i0 + ni, j0:j0 + nj] * att(b, k, i0, ni, j0, nj))
            agg += torch.einsum("ij,ict->jct", A, x4[b, i0:i0 + ni, c0:c0 + cn, t0:t0 + tc])
        return agg

    y = torch.zeros(B, N, Co, T)
    th = md(thetas)
    for b in range(B):
        for j0, nj in tiles:
            for t0, tc in _time_spans(T, C, Co):
                for o0, on in _channel_spans(Co):  # the Co chunks: blocks of the grid
                    for k in range(K):
                        for c0, cn in _channel_spans(C):  # the Θ mix over C chunks in order
                            agg = md(aggregate(b, k, j0, nj, c0, cn, t0, tc))
                            y[b, j0:j0 + nj, o0:o0 + on, t0:t0 + tc] += torch.einsum(
                                "jct,co->jot", agg, th[k, c0:c0 + cn, o0:o0 + on])
    y = torch.relu(y).reshape(B, N, Co * T)
    return y, dict(qk=qk, semx=semx, xhat=xhat, inv=inv, att=att, score=score,
                   aggregate=aggregate, tiles=tiles, steps=steps)


def _wide_backward(g, y, tat, xm, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, mid):
    """The backward kernels with every width chunked (float32): cols_bwd by
    (target tile, time chunk, C chunk), for each k agg again, then Co a chunk
    at a time (gm staged, the dΘ partial, dagg's sums over Co), md(dagg) and
    δ_j = dagg_j·agg_j a chunk; ds (dA over every chunk, ds = att (cheb dA −
    Σ δ), dbias summed over b in order, the dk partial summed in place a
    d_k chunk at a time over the source steps); dq a d_k chunk at a time;
    the dxm row pass a chunk at a time; SD with dsemx = dq·wqkᵀ in chunks of
    d (dq staged HC columns at a time), the LayerNorm backward's row sums
    over the chunks, dtat's share added a chunk at a time. Returns the
    gradients of (tat, xm, pw, pb, pos, gs, bs, wqk, bias, thetas)."""
    B, N, _ = tat.shape
    d, C = pw.shape[1], thetas.shape[1]
    Co, K = thetas.shape[2], bias.shape[0]
    T = xm.shape[-1] // C
    dk, hk = wqk.shape[1] // (2 * K), wqk.shape[1] // 2
    inv_dk = 1.0 / math.sqrt(dk)
    qk, att, aggregate = mid["qk"], mid["att"], mid["aggregate"]
    tiles, steps = mid["tiles"], mid["steps"]
    gm = (g * (y > 0)).reshape(B, N, Co, T)
    spans_c, spans_o, spans_t = _channel_spans(C), _channel_spans(Co), _time_spans(T, C, Co)
    dagg = torch.zeros(B, K, N, C, T)
    delta = torch.zeros(B, K, len(spans_t) * len(spans_c), N)
    dth = torch.zeros_like(thetas)
    for b in range(B):
        for j0, nj in tiles:
            for h, (t0, tc) in enumerate(spans_t):
                for gi, (c0, cn) in enumerate(spans_c):
                    for k in range(K):
                        agg = aggregate(b, k, j0, nj, c0, cn, t0, tc)
                        dacc = torch.zeros(nj, cn, tc)
                        for o0, on in spans_o:
                            gc = gm[b, j0:j0 + nj, o0:o0 + on, t0:t0 + tc]
                            dth[k, c0:c0 + cn, o0:o0 + on] += torch.einsum("jct,jot->co", agg, gc)
                            dacc = dacc + torch.einsum("jot,co->jct", gc,
                                                       thetas[k, c0:c0 + cn, o0:o0 + on])
                        dagg[b, k, j0:j0 + nj, c0:c0 + cn, t0:t0 + tc] = dacc
                        delta[b, k, h * len(spans_c) + gi, j0:j0 + nj] = (dacc * agg).sum((1, 2))
    dbias = torch.zeros_like(bias)
    dS = torch.zeros(B, K, N, N)
    dqk = torch.zeros_like(qk)
    for j0, nj in tiles:
        for k in range(K):
            for b in range(B):
                dl = delta[b, k, :, j0:j0 + nj].sum(0)
                dkp = torch.zeros(nj, dk)
                for i0, ni in steps:
                    a_ = att(b, k, i0, ni, j0, nj)
                    dA = xm[b, i0:i0 + ni] @ dagg[b, k, j0:j0 + nj].reshape(nj, -1).T
                    ds = a_ * (cheb[k, i0:i0 + ni, j0:j0 + nj] * dA - dl)
                    dbias[k, i0:i0 + ni, j0:j0 + nj] += ds
                    dS[b, k, i0:i0 + ni, j0:j0 + nj] = ds
                    for c0, cw in _spans(dk, DKC):
                        dkp[:, c0:c0 + cw] += ds.T @ qk[b, i0:i0 + ni,
                                                        k * dk + c0:k * dk + c0 + cw]
                dqk[b, j0:j0 + nj, hk + k * dk:hk + (k + 1) * dk] = dkp * inv_dk
    dxm = torch.zeros(B, N, C, T)
    for b in range(B):
        for i0, ni in tiles:
            for k in range(K):
                for c0, cw in _spans(dk, DKC):
                    dq = torch.zeros(ni, cw)
                    for j0, nj in steps:
                        dq += dS[b, k, i0:i0 + ni, j0:j0 + nj] @ qk[
                            b, j0:j0 + nj, hk + k * dk + c0:hk + k * dk + c0 + cw]
                    dqk[b, i0:i0 + ni, k * dk + c0:k * dk + c0 + cw] = dq * inv_dk
            for t0, tc in spans_t:
                for c0, cn in spans_c:
                    for k in range(K):
                        for j0, nj in steps:
                            A = cheb[k, i0:i0 + ni, j0:j0 + nj] * att(b, k, i0, ni, j0, nj)
                            dxm[b, i0:i0 + ni, c0:c0 + cn, t0:t0 + tc] += torch.einsum(
                                "ij,jct->ict", A, dagg[b, k, j0:j0 + nj, c0:c0 + cn, t0:t0 + tc])
    # SD in chunks of d, dq staged HC columns at a time
    dq_rows, xhat, inv = dqk.reshape(B * N, -1), mid["xhat"], mid["inv"]

    def dsemx(c0, cn):
        z = torch.zeros(B * N, cn)
        for h0, hn in _spans(2 * hk, HC):
            z = z + dq_rows[:, h0:h0 + hn] @ wqk[c0:c0 + cn, h0:h0 + hn].T
        return z

    m1, m2 = torch.zeros(B * N), torch.zeros(B * N)
    dgs, dbs = torch.zeros(d), torch.zeros(d)
    for c0, cn in _spans(d, DC):
        pre = dsemx(c0, cn)
        gy = pre * gs[c0:c0 + cn]
        m1, m2 = m1 + gy.sum(1), m2 + (gy * xhat[:, c0:c0 + cn]).sum(1)
        dgs[c0:c0 + cn] = (pre * xhat[:, c0:c0 + cn]).sum(0)
        dbs[c0:c0 + cn] = pre.sum(0)
    dse = torch.empty(B * N, d)
    dtat = torch.zeros(B * N, tat.shape[-1])
    for c0, cn in _spans(d, DC):
        gy = dsemx(c0, cn) * gs[c0:c0 + cn]
        dse[:, c0:c0 + cn] = inv * (gy - (m1 / d)[:, None] - xhat[:, c0:c0 + cn] * (m2 / d)[:, None])
        dtat = dtat + dse[:, c0:c0 + cn] @ pw[:, c0:c0 + cn].T
    rows = tat.reshape(B * N, -1)
    return (dtat.reshape(tat.shape), dxm.reshape(xm.shape), rows.T @ dse, dse.sum(0),
            dse.reshape(B, N, d).sum(0), dgs, dbs, mid["semx"].T @ dqk.reshape(B * N, -1),
            dbias, dth)


class _WideMiddle(torch.autograd.Function):
    """The emulated kernels in the place of SpatialMiddle (no dropout)."""

    @staticmethod
    def forward(ctx, tat, xm, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas):
        y, mid = _wide_forward(tat, xm, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas,
                               lambda a: a)
        ctx.mid = mid
        ctx.save_for_backward(tat, xm, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, y)
        return y

    @staticmethod
    def backward(ctx, g):
        *ins, y = ctx.saved_tensors
        grads = _wide_backward(g, y, *ins, ctx.mid)
        return (*grads[:9], None, grads[9])


def _kernel_form(t, adj, cheb):
    """fused_spatial_middle's kernel operands from its arguments, by the
    wrapper's own (differentiable) reshapes."""
    pw = t["pre_w"][:, :, 0, :].permute(2, 1, 0).reshape(SF * ST, SD)
    tat = t["tat"].reshape(SB, SF * ST, SN).transpose(1, 2)
    wqk = torch.cat([t["wq"], t["wk"]], dim=1)
    return (tat, t["x"].reshape(SB, SN, SC * ST), pw, t["pre_b"], t["pos"], t["gs"], t["bs"],
            wqk, adj[None] * t["masks"], cheb, t["thetas"])


def test_wide_spatial_schedule_matches_plain_and_jax():
    """C = Co = 40 in channel chunks of 14, 14, 12 (a chunk's most columns
    forced to 16, so one time step a chunk: four time chunks), d = 40 in
    chunks of 16, 16, 8, the SAt's d_k = 24 in chunks of 8, 2·K·d_k = 96 in
    SD's chunks of 32, N = 29 in tiles and steps of 16: every multi-chunk
    branch runs. Forward and every gradient against the port's plain
    version (autograd) and JAX's fused_spatial_middle in interpret mode."""
    assert len(_channel_spans(SC)) == 3 and len(_time_spans(ST, SC, SCO)) == ST
    assert len(_spans(SD, DC)) == 3 and len(_spans(SDK, DKC)) == 3
    a, adj, cheb, cot = _sp_arrays()
    runs = {}
    for name in ("wide", "plain"):
        t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in a.items()}
        adj_t, cheb_t = torch.from_numpy(adj), torch.from_numpy(cheb)
        if name == "wide":
            out = _WideMiddle.apply(*_kernel_form(t, adj_t, cheb_t)).reshape(SB, SN, SCO, ST)
        else:
            out = bsf.fused_spatial_middle(t["tat"], t["x"], **_sp_kw(t, adj_t, cheb_t))
        out.backward(torch.from_numpy(cot))
        runs[name] = (out.detach().numpy(), {k: v.grad.numpy() for k, v in t.items()})
    j_out, j_vjp = jax.vjp(lambda t: jbsf.fused_spatial_middle(
        t["tat"], t["x"], **_sp_kw(t, jnp.asarray(adj), jnp.asarray(cheb))),
        {k: jnp.asarray(v) for k, v in a.items()})
    (j_g,) = j_vjp(jnp.asarray(cot))
    runs["jax"] = (np.asarray(j_out), {k: np.asarray(v) for k, v in j_g.items()})
    got_out, got_g = runs.pop("wide")
    assert float(np.abs(got_out).max()) > 0.1  # the ReLU leaves a live output
    for name, (want_out, want_g) in runs.items():
        _close(got_out, want_out, FWD_TOL, f"{name} out")
        for k in a:
            _close(got_g[k], want_g[k], GRAD_TOL, f"{name} d{k}")


def test_wide_spatial_forward_in_bfloat16():
    """bf16: the emulated forward with the matmul operands rounded where the
    kernels cast them (md(tat), semx, md(q), md(k), md(A), md(xm), md(agg),
    the weights bf16-exact) against the plain version in bf16 within 1e-2
    of the output's scale."""
    a, adj, cheb, _ = _sp_arrays(4)
    t = {k: torch.from_numpy(v).bfloat16() for k, v in a.items()}
    adj_t, cheb_t = torch.from_numpy(adj).bfloat16(), torch.from_numpy(cheb).bfloat16()
    want = bsf.fused_spatial_middle(t["tat"], t["x"], **_sp_kw(t, adj_t, cheb_t))
    ops = [o.float() for o in _kernel_form(t, adj_t, cheb_t)]
    md = lambda v: v.bfloat16().float()
    y, _ = _wide_forward(*ops, md)
    _close(md(y).reshape(SB, SN, SCO, ST), want.float(), BF16_TOL, "out")


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

# mostly the sizes models take, sometimes past CUDA's grid or int32 limits
TAT_SHAPES = dict(BF=st.one_of(st.integers(1, 4096), st.integers(1, 2 ** 28)),
                  T=st.integers(1, 2000), N=st.one_of(st.integers(1, 9000),
                                                      st.integers(1, 2 ** 23)),
                  H=st.one_of(st.integers(1, 16), st.integers(1, 70000)),
                  dk=st.integers(1, 1200), dv=st.integers(1, 1200),
                  dtype=st.sampled_from([torch.float32, torch.bfloat16]),
                  embed=st.booleans(), backward=st.booleans())


@settings(max_examples=200, deadline=None)
@given(**TAT_SHAPES)
def test_tat_gate_refuses_exactly_the_grid_and_int32(BF, T, N, H, dk, dv, dtype, embed,
                                                      backward):
    """tat_fused.limit_error, the gate the wrappers raise at launch and the
    Trainer's at build, refuses a shape exactly where CUDA's grid (H heads,
    N's and H·d_v's 64-column tiles of the weight gradients, at most
    65,535) or int32 indices (B·F·T, T·N, N·W, H·d_v·N) are passed, never
    for a head width, N or T; every shape it admits has a plan whose every
    pass takes rows and fits a block."""
    gate = tat_fused.limit_error(T, N, H, dk, dv, dtype, backward, embed, BF=BF)
    W = H * (2 * dk + dv)
    bad_grid = H > 65535 or -(-N // 64) > 65535 or -(-(H * dv) // 64) > 65535
    bad_index = max(BF * T, T * N, N * W, H * dv * N) >= 2 ** 31
    assert (gate is None) == (not (bad_grid or bad_index))
    if gate is not None:
        assert ("grid too large" in gate) == bad_grid or "int32" in gate
        return
    plan = tat_fused.plan(T, N, H, dk, dv, embed, dtype)
    assert all(p["rows"] > 0 and p["bytes"] <= SMEM_MAX for p in plan.values()), plan


SPATIAL_SHAPES = dict(B=st.one_of(st.integers(1, 64), st.integers(1, 70000)),
                      N=st.one_of(st.integers(1, 3000), st.integers(1, 2 ** 20)),
                      F=st.integers(1, 600), T=st.integers(1, 600), C=st.integers(1, 1500),
                      Co=st.integers(1, 1500), d=st.integers(1, 9000), K=st.integers(1, 6),
                      dk=st.integers(1, 1200),
                      dtype=st.sampled_from([torch.float32, torch.bfloat16]))


@settings(max_examples=200, deadline=None)
@given(**SPATIAL_SHAPES)
def test_spatial_gate_refuses_exactly_the_grid_and_int32(B, N, F, T, C, Co, d, K, dk, dtype):
    """block_spatial_fused.limit_error refuses a shape exactly where CUDA's
    grid (the batch, K and the column and row passes' chunks at most
    65,535) or int32 indices (B·N times the widest row, K·C·Co) are passed,
    never for C, Co, d or d_k; every shape it admits has a plan whose every
    kernel fits a block."""
    gate = bsf.limit_error(N, F * T, C, T, Co, d, K, dk, dtype, B)
    _, nT = bsf.time_chunks(T, C, Co)
    bad_grid = max(B, K, nT * bsf.channel_chunks(C)[1], nT * bsf.channel_chunks(Co)[1]) > 65535
    bad_index = max(B * N * max(F * T, C * T, Co * T, d, 2 * K * dk), K * C * Co) >= 2 ** 31
    assert (gate is None) == (not (bad_grid or bad_index))
    if gate is not None:
        assert "grid too large" in gate or "int32" in gate
        return
    assert max(bsf.smem_bytes(N, F * T, C, T, Co, d, K, dk, dtype).values()) <= SMEM_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gates_admit_the_widths_the_card_refused(dtype):
    """The widths the card refused before the kernels chunked them: the TAt
    backward at T = 144 and 160 with d_k = d_v = 128 (any H), d_k = d_v =
    256 from T = 48 to 160, the LN1-backward pass at 8 heads of 128 (N =
    170 and 2139) and H·d_v up to 4096; the spatial middle's C or Co past
    384, d from 3,500 up, the SAt's d_k from 512 up."""
    for T in (144, 160):
        for H in (1, 2, 8):
            for backward in (False, True):
                assert tat_fused.limit_error(T, 2139, H, 128, 128, dtype, backward) is None
    for T in (48, 96, 160):
        assert tat_fused.limit_error(T, 170, 2, 256, 256, dtype, True) is None
    for N in (170, 2139):
        for H, dv in ((8, 128), (8, 512), (1, 4096)):
            for backward in (False, True):
                assert tat_fused.limit_error(12, N, H, dv, dv, dtype, backward) is None
    for shape in ((170, 6144, 512, 12, 512, 4096, 3, 128), (170, 384, 32, 12, 385, 512, 3, 32),
                  (170, 12, 1, 12, 32, 3500, 3, 32), (170, 384, 32, 12, 32, 512, 3, 512),
                  (170, 384, 32, 12, 32, 512, 3, 2048)):
        assert bsf.limit_error(*shape, dtype) is None
        assert max(bsf.smem_bytes(*shape, dtype).values()) <= SMEM_MAX


# ---------------------------------------------------------------------------
# the Trainer's card check on chip_smoke.py's two CLI projects
# ---------------------------------------------------------------------------

def _project(name, dtype, batch_size=None):
    """The wide_heads project (GAMBIA: N = 2139, T = 144, 4 features, batch
    4, 8 heads of d_k = d_v = 128) or the wide_channels one (PEMS08 width:
    N = 170, T = 12, nb_chev_filter = nb_time_filter = 512, d_model = 4096,
    8 heads of 128, batch 8), both with fuse_tat and fuse_spatial."""
    if name == "wide_heads":
        data = dict(num_of_vertices=2139, len_input=144)
        train = dict(in_channels=4, nb_block=2, K=2, d_model=64, nb_chev_filter=32,
                     nb_time_filter=32, batch_size=4, num_of_hours=12)
    else:
        data = dict(num_of_vertices=170, len_input=12)
        train = dict(in_channels=1, nb_block=4, K=3, d_model=4096, nb_chev_filter=512,
                     nb_time_filter=512, batch_size=8, num_of_hours=1)
    if batch_size is not None:
        train["batch_size"] = batch_size
    return Config(data=DataConfig(num_for_predict=12, dataset_name=name, points_per_hour=12,
                                  **data),
                  training=TrainingConfig(n_heads=8, d_k=128, d_v=128, fuse_tat=True,
                                          fuse_spatial=True, compute_dtype=dtype,
                                          **train)).validate()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["wide_heads", "wide_channels"])
def test_check_fused_shapes_builds_the_wide_projects(monkeypatch, name, dtype):
    """check_fused_shapes admits both projects on a CUDA device (it reads
    only ``device.type``, so it runs here), and it asks the TAt gate (and
    the spatial one) exactly what each block's launches ask: the block's T,
    N, heads and B·F, both directions, the model's call without the
    embedding; each answer None."""
    cfg, dt = _project(name, dtype), getattr(torch, dtype)
    asked, real = [], tat_fused.limit_error
    monkeypatch.setattr(tat_fused, "limit_error", lambda *a, **k: asked.append((a, k))
                        or real(*a, **k))
    loop.check_fused_shapes(cfg, torch.device("cuda"), dt)
    spec = ModelSpec.from_config(cfg)
    want = []
    for i, (F, C) in enumerate(spec.block_specs):
        T_i = cfg.data.len_input if i == 0 else cfg.data.len_input // spec.time_strides
        want += [((T_i, cfg.data.num_of_vertices, 8, 128, 128, dt, backward),
                  dict(embed=False, BF=cfg.training.batch_size * F)) for backward in (False, True)]
        assert bsf.limit_error(cfg.data.num_of_vertices, F * T_i, C, T_i, spec.nb_chev_filter,
                               spec.d_model, spec.K, spec.d_k, dt,
                               cfg.training.batch_size) is None
    assert asked == want
    assert all(real(*a, **k) is None for a, k in asked)


def test_check_fused_shapes_refuses_fuse_tat_past_int32():
    """A fuse_tat block past the passes' int32 guard (B·F·T rows) raises at
    build, naming fuse_tat, where it used to pass the build and raise at
    the first step; the CPU takes it."""
    cfg = _project("wide_heads", "float32", batch_size=2 ** 31 // (4 * 144) + 1)
    with pytest.raises(ValueError, match=r"fuse_tat=true but on the card block 1: .*int32"):
        loop.check_fused_shapes(cfg, torch.device("cuda"), torch.float32)
    loop.check_fused_shapes(cfg, torch.device("cpu"), torch.float32)
