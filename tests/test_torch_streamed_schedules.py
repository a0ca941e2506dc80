"""CPU emulations of the CUDA kernels' streamed schedules, held against the
JAX package's Pallas kernels in interpret mode.

The card's kernels cannot run here, so their schedules are written out in
torch, with the chunk sizes forced small so that every multi-tile branch
runs, and held against JAX on the same numpy-seeded inputs and weights:

- the fused TAt (csrc/tat_fused.cu): LN1's forward and backward over
  column chunks of N (the chunks' statistics merged by Chan's formula, the
  forward's second sweep last chunk first with the others read back from
  its scratch, the backward's sweeps through its scratch rows and per-row-tile column
  partials), LN0's backward with the embedding in chunks, and the
  query-axis softmax streamed in query tiles and key chunks (each key
  column's running max and sum of exp over the query tiles, ctx rebuilt
  from them; backward delta_k and g_v, then ds, g_k and g_q summed over the
  key chunks), with the score residual; N = 45 in chunks of 16, T = 40 in
  query tiles and key chunks of 8;
- the fused GTU (csrc/gtu_fused.cu): time tiles of 16 steps with x staged
  over the tile and the taps' reach, the backward's 16-step halo of
  recomputed y before each tile, channel groups of 16 pairs, C contracted
  in chunks of 16, dx accumulated over the (conv, group) launches in order,
  dW and db per (group, channel chunk); C = 48, T = 64.

Tolerances: forward 2e-4, gradients 5e-3, of each tensor's scale.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.ops.pallas.gtu_fused import gtu_cat as jax_gtu_cat
from dstagnn_drought_tpu.ops.pallas.tat_fused import fused_temporal_attention as jax_tat

torch.set_num_threads(1)

EPS = 1e-5
FWD_TOL, GRAD_TOL = 2e-4, 5e-3


def _close(got, want, tol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: {err:.3g} of scale > {tol}"


# ---------------------------------------------------------------------------
# the fused TAt
# ---------------------------------------------------------------------------

B, F, T, N, H, DK, DV = 2, 2, 40, 45, 2, 8, 8
NC, QT, KC, ROWS = 16, 8, 8, 16  # column chunk, query tile, key chunk, rows a tile


def _tat_arrays(seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale=0.3: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(
        x=mk(B, F, T, N, scale=1.0), pos=mk(T, N), g0=1 + mk(N, scale=0.1), b0=mk(N, scale=0.1),
        wq=mk(N, H * DK), wk=mk(N, H * DK), wv=mk(N, H * DV), wo=mk(H * DV, N),
        g1=1 + mk(N, scale=0.1), b1=mk(N, scale=0.1), res=mk(B, F, H, T, T, scale=0.5),
        g_out=mk(B, F, T, N, scale=1.0), g_sc=mk(B, F, H, T, T, scale=0.1),
    )


def _jax_tat(a, embed):
    names = ("x", "pos", "g0", "b0", "wq", "wk", "wv", "wo", "g1", "b1", "res")

    def f(x, pos, g0, b0, wq, wk, wv, wo, g1, b1, res):
        return jax_tat(x, res, pos=pos if embed else None, ln0_scale=g0 if embed else None,
                       ln0_bias=b0 if embed else None, wq=wq, wk=wk, wv=wv, wo=wo,
                       ln_scale=g1, ln_bias=b1, n_heads=H, d_k=DK, d_v=DV)

    (out, sc), vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a[n]) for n in names))
    grads = vjp((jnp.asarray(a["g_out"]), jnp.asarray(a["g_sc"])))
    return np.asarray(out), np.asarray(sc), dict(zip(names, (np.asarray(g) for g in grads)))


def _chunks(n_cols):
    """(c0, width, valid) of the N-wide passes' column chunks: the padded
    width in chunks of NC, only the last holding padding."""
    Np = (n_cols + 15) // 16 * 16
    return [(c0, min(NC, Np - c0), min(NC, n_cols - c0)) for c0 in range(0, Np, NC)]


def _merge(zc, n, stats):
    """Chan's merge of the chunk's columns zc (rows, cv) into the running
    (mean, m2) over the first n columns (pass 3's and 4's merge_row)."""
    cv = zc.shape[1]
    mc = zc.sum(1) / cv
    v = ((zc - mc[:, None]) ** 2).sum(1)
    if n == 0:
        return mc, v
    mean, m2 = stats
    delta, nn = mc - mean, float(n + cv)
    return mean + delta * (cv / nn), m2 + v + delta * delta * (n * cv / nn)


def _row_tiles(v):
    """The per-row-tile partial column sums of v (M, n), summed in tile
    order (the kernels' per-block partials and dense::sum_rows)."""
    parts = [v[r0:r0 + ROWS].sum(0) for r0 in range(0, v.shape[0], ROWS)]
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _streamed_tat(a, embed):
    """The kernels' passes 1-7 on the (B·F·T, N) rows, forward and backward,
    with the streamed schedules; returns (out, scores, grads)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    BF, M = B * F, B * F * T
    x = t["x"].reshape(M, N)
    pos = t["pos"].repeat(BF, 1)
    wqkv = torch.cat([t["wq"], t["wk"], t["wv"]], 1)
    wo, g0, b0, g1, b1 = t["wo"], t["g0"], t["b0"], t["g1"], t["b1"]
    res = t["res"].reshape(BF, H, T, T)
    g_out, g_sc = t["g_out"].reshape(M, N), t["g_sc"].reshape(BF, H, T, T)
    inv_sqrt = 1.0 / math.sqrt(DK)
    # pass 1: te (LN0's row statistics from the whole row) and qkv
    if embed:
        zx = x + pos
        mu0 = zx.mean(1, keepdim=True)
        inv0 = torch.rsqrt(((zx - mu0) ** 2).mean(1, keepdim=True) + EPS)
        xh0 = (zx - mu0) * inv0
        te = xh0 * g0 + b0
    else:
        te = x
    qkv = te @ wqkv
    hk = H * DK
    q = qkv[:, :hk].reshape(BF, T, H, DK).permute(0, 2, 1, 3)
    k = qkv[:, hk:2 * hk].reshape(BF, T, H, DK).permute(0, 2, 1, 3)
    v = qkv[:, 2 * hk:].reshape(BF, T, H, DV).permute(0, 2, 1, 3)

    def score(q0, k0):
        return (q[:, :, q0:q0 + QT] @ k[:, :, k0:k0 + KC].transpose(-1, -2) * inv_sqrt
                + res[:, :, q0:q0 + QT, k0:k0 + KC])

    # pass 2: each key chunk's column statistics over the query tiles (the
    # running max and the rescaled sum of exp), the raw scores, then ctx
    # a query tile at a time from the statistics
    scores = torch.empty(BF, H, T, T)
    cmax, csum = torch.empty(BF, H, T), torch.empty(BF, H, T)
    for k0 in range(0, T, KC):
        m = torch.full((BF, H, min(KC, T - k0)), -math.inf)
        l = torch.zeros_like(m)
        for q0 in range(0, T, QT):
            s = score(q0, k0)
            scores[:, :, q0:q0 + QT, k0:k0 + KC] = s
            m_new = torch.maximum(m, s.max(2).values)
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, :, None]).sum(2)
            m = m_new
        cmax[:, :, k0:k0 + KC], csum[:, :, k0:k0 + KC] = m, l

    def attn(q0, k0):
        s = score(q0, k0)
        return torch.exp(s - cmax[:, :, None, k0:k0 + KC]) / csum[:, :, None, k0:k0 + KC]

    ctx = torch.zeros(BF, H, T, DV)
    for q0 in range(0, T, QT):
        for k0 in range(0, T, KC):
            ctx[:, :, q0:q0 + QT] += attn(q0, k0) @ v[:, :, k0:k0 + KC]
    ctx = ctx.permute(0, 2, 1, 3).reshape(M, H * DV)
    # pass 3: z chunk by chunk into its scratch, the statistics merged; out
    # last chunk first, the others read back from the scratch
    chunks = _chunks(N)

    def z_chunk(c0, cv):
        return ctx @ wo[:, c0:c0 + cv] + te[:, c0:c0 + cv]

    stats = None
    zbuf = torch.zeros(M, N)
    for c0, _, cv in chunks:
        zbuf[:, c0:c0 + cv] = z_chunk(c0, cv)
        stats = _merge(zbuf[:, c0:c0 + cv], c0, stats)
    mean, m2 = stats
    inv1 = torch.rsqrt(m2 / N + EPS)[:, None]
    out = torch.empty(M, N)
    for c0, _, cv in reversed(chunks):
        out[:, c0:c0 + cv] = (zbuf[:, c0:c0 + cv] - mean[:, None]) * inv1 * g1[c0:c0 + cv] \
            + b1[c0:c0 + cv]
    # pass 4: z to the scratch rows; x_hat, the row sums and the per-tile
    # column partials; g_ypre; g_ctx
    scratch = torch.zeros(M, N)
    for c0, _, cv in chunks:
        scratch[:, c0:c0 + cv] = z_chunk(c0, cv)
    s1, s2 = torch.zeros(M), torch.zeros(M)
    dg1, db1 = torch.zeros(N), torch.zeros(N)
    for c0, _, cv in chunks:
        xh = (scratch[:, c0:c0 + cv] - mean[:, None]) * inv1
        gg = g_out[:, c0:c0 + cv] * g1[c0:c0 + cv]
        s1, s2 = s1 + gg.sum(1), s2 + (gg * xh).sum(1)
        dg1[c0:c0 + cv] = _row_tiles(g_out[:, c0:c0 + cv] * xh)
        db1[c0:c0 + cv] = _row_tiles(g_out[:, c0:c0 + cv])
        scratch[:, c0:c0 + cv] = xh
    gy = torch.empty(M, N)
    for c0, _, cv in chunks:
        gg = g_out[:, c0:c0 + cv] * g1[c0:c0 + cv]
        gy[:, c0:c0 + cv] = inv1 * (gg - (s1 / N)[:, None]
                                    - scratch[:, c0:c0 + cv] * (s2 / N)[:, None])
    gctx = (gy @ wo.t()).reshape(BF, T, H, DV).permute(0, 2, 1, 3)
    # pass 5: a key chunk at a time: delta and g_v over the query tiles,
    # then ds -> dres, g_k of the chunk and g_q summed over the chunks
    dres = torch.empty(BF, H, T, T)
    gq, gk, gv = torch.zeros(BF, H, T, DK), torch.zeros(BF, H, T, DK), torch.zeros(BF, H, T, DV)
    for k0 in range(0, T, KC):
        vk, kk_ = v[:, :, k0:k0 + KC], k[:, :, k0:k0 + KC]
        delta = torch.zeros(BF, H, vk.shape[2])
        for q0 in range(0, T, QT):
            a_t = attn(q0, k0)
            ga = gctx[:, :, q0:q0 + QT] @ vk.transpose(-1, -2)
            delta = delta + (a_t * ga).sum(2)
            gv[:, :, k0:k0 + KC] += a_t.transpose(-1, -2) @ gctx[:, :, q0:q0 + QT]
        for q0 in range(0, T, QT):
            a_t = attn(q0, k0)
            ga = gctx[:, :, q0:q0 + QT] @ vk.transpose(-1, -2)
            ds = a_t * (ga - delta[:, :, None]) + g_sc[:, :, q0:q0 + QT, k0:k0 + KC]
            dres[:, :, q0:q0 + QT, k0:k0 + KC] = ds
            gk[:, :, k0:k0 + KC] += ds.transpose(-1, -2) @ q[:, :, q0:q0 + QT]
            gq[:, :, q0:q0 + QT] += (ds @ kk_) * inv_sqrt
    gk = gk * inv_sqrt
    rows = lambda g: g.permute(0, 2, 1, 3).reshape(M, -1)
    gqkv = torch.cat([rows(gq), rows(gk), rows(gv)], 1)
    # pass 6: g_te; with the embedding LN0's backward chunk by chunk through
    # dxf (the row sums and per-tile column partials), then dx
    gte = gqkv @ wqkv.t() + gy
    grads = {}
    if embed:
        dxf = torch.empty(M, N)
        s1, s2 = torch.zeros(M), torch.zeros(M)
        dg0, db0 = torch.zeros(N), torch.zeros(N)
        for c0, _, cv in chunks:
            z = gte[:, c0:c0 + cv]
            gg = z * g0[c0:c0 + cv]
            s1, s2 = s1 + gg.sum(1), s2 + (gg * xh0[:, c0:c0 + cv]).sum(1)
            dg0[c0:c0 + cv] = _row_tiles(z * xh0[:, c0:c0 + cv])
            db0[c0:c0 + cv] = _row_tiles(z)
            dxf[:, c0:c0 + cv] = z
        dx = inv0 * (dxf * g0 - (s1 / N)[:, None] - xh0 * (s2 / N)[:, None])
        grads.update(pos=dx.reshape(BF, T, N).sum(0), g0=dg0, b0=db0)
    else:
        dx = gte
    # pass 7: the weight gradients
    dwqkv = te.t() @ gqkv
    grads.update(x=dx.reshape(B, F, T, N), wq=dwqkv[:, :hk], wk=dwqkv[:, hk:2 * hk],
                 wv=dwqkv[:, 2 * hk:], wo=ctx.t() @ gy, g1=dg1, b1=db1,
                 res=dres.reshape(B, F, H, T, T))
    return out.reshape(B, F, T, N), scores.reshape(B, F, H, T, T), grads


@pytest.mark.parametrize("embed", [False, True], ids=["no_embed", "embed"])
def test_streamed_tat_schedule_matches_jax(embed):
    """N = 45 in three column chunks of 16 (the last with padding), T = 40
    in five query tiles and five key chunks of 8, four row tiles of 16:
    every multi-chunk and multi-tile branch of passes 2-6 runs."""
    assert len(_chunks(N)) == 3 and -(-T // QT) == 5 and -(-B * F * T // ROWS) > 1
    a = _tat_arrays(1 if embed else 0)
    j_out, j_sc, j_grads = _jax_tat(a, embed)
    out, sc, grads = _streamed_tat(a, embed)
    _close(out, j_out, FWD_TOL, "out")
    _close(sc, j_sc, FWD_TOL, "scores")
    names = ("x", "wq", "wk", "wv", "wo", "g1", "b1", "res") + (
        ("pos", "g0", "b0") if embed else ())
    for name in names:
        _close(grads[name], j_grads[name], GRAD_TOL, name)


def test_chan_merge_of_one_chunk_is_the_two_pass_statistics():
    """One chunk (every row up to 1024 columns) gives the two-pass mean and
    sum of squared deviations exactly, as ln_stats formed them; several
    chunks agree with them within float32 rounding."""
    z = torch.from_numpy(np.random.default_rng(2).normal(3.0, 2.0, (7, 45)).astype(np.float32))
    mean, m2 = _merge(z, 0, None)
    assert torch.equal(mean, z.sum(1) / 45)
    assert torch.equal(m2, ((z - mean[:, None]) ** 2).sum(1))
    stats = None
    for c0, _, cv in _chunks(45):
        stats = _merge(z[:, c0:c0 + cv], c0, stats)
    torch.testing.assert_close(stats[0], mean, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(stats[1], m2, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the fused GTU
# ---------------------------------------------------------------------------

GB, GN, GC, GT = 2, 3, 48, 64
G, CK, TT, HALO, KZ = 16, 16, 16, 16, 8
KS = (3, 5, 7)


def _gtu_arrays(seed=3):
    rng = np.random.default_rng(seed)
    a = {"x": (rng.normal(size=(GB, GN, GC, GT)) * 0.5).astype(np.float32)}
    for k in KS:
        a[f"w{k}"] = (rng.normal(size=(2 * GC, GC, 1, k)) * (GC * k) ** -0.5).astype(np.float32)
        a[f"b{k}"] = (rng.normal(size=2 * GC) * 0.1).astype(np.float32)
    a["g"] = rng.normal(size=(GB, GN, 3 * GT - 12, GC)).astype(np.float32)
    return a


def _jax_gtu(a):
    names = ("x", "w3", "b3", "w5", "b5", "w7", "b7")
    out, vjp = jax.vjp(jax.jit(lambda *args: jax_gtu_cat(True, *args)),
                       *(jnp.asarray(a[n]) for n in names))
    grads = vjp(jnp.asarray(a["g"]))
    return np.asarray(out), dict(zip(names, (np.asarray(g) for g in grads)))


def _tiled_gtu(a):
    """The kernels' schedule on all (b, n) groups at once: returns (out,
    grads)."""
    x = torch.from_numpy(a["x"]).reshape(GB * GN, GC, GT)
    g = torch.from_numpy(a["g"]).reshape(GB * GN, 3 * GT - 12, GC)
    ws = [torch.from_numpy(a[f"w{k}"])[:, :, 0, :] for k in KS]  # (2C, C, k)
    bs = [torch.from_numpy(a[f"b{k}"]) for k in KS]
    BN, ngroups, ntiles = GB * GN, GC // G, -(-GT // TT)
    offs = np.cumsum([0] + [GT - k + 1 for k in KS])

    def xs(ty0, rows):
        """x time-major over [ty0, ty0 + rows), zero outside [0, T)."""
        out = torch.zeros(BN, rows, GC)
        a0, b0 = max(ty0, 0), min(GT, ty0 + rows)
        if b0 > a0:
            out[:, a0 - ty0:b0 - ty0] = x[:, :, a0:b0].transpose(1, 2)
        return out

    def pair_rows(og):
        return list(range(og * G, og * G + G)) + list(range(GC + og * G, GC + og * G + G))

    def y_tile(w, b, og, ty0, rows):
        """y of group og's pairs over [ty0, ty0 + rows), C contracted in
        chunks of CK, x staged over the rows and the taps' reach."""
        k = w.shape[2]
        xt = xs(ty0, rows + 8)
        wg = w[pair_rows(og)]  # (2G, C, k)
        y = torch.zeros(BN, rows, 2 * G)
        for c0 in range(0, GC, CK):
            for kk in range(k):
                y += xt[:, kk:kk + rows, c0:c0 + CK] @ wg[:, c0:c0 + CK, kk].t()
        return y + b[pair_rows(og)]

    out = torch.zeros(BN, 3 * GT - 12, GC)
    for ki, (w, b) in enumerate(zip(ws, bs)):
        Tout = GT - KS[ki] + 1
        for og in range(ngroups):
            for ti in range(ntiles):
                t0 = ti * TT
                y = y_tile(w, b, og, t0, TT)
                gate = torch.tanh(y[..., :G]) * torch.sigmoid(y[..., G:])
                n = max(0, min(TT, Tout - t0))
                out[:, offs[ki] + t0:offs[ki] + t0 + n, og * G:og * G + G] = gate[:, :n]
    # backward: the (conv, group) launches in order, dx accumulated; dW and
    # db per (group, channel chunk) over the items
    dx_acc = torch.zeros(BN, GC, GT)
    dws = [torch.zeros_like(w) for w in ws]
    dbs = [torch.zeros_like(b) for b in bs]
    for ki, (w, b) in enumerate(zip(ws, bs)):
        k, Tout = KS[ki], GT - KS[ki] + 1
        for og in range(ngroups):
            rows_og = pair_rows(og)
            for ti in range(ntiles):
                t0 = ti * TT
                ty0 = t0 - HALO
                y = y_tile(w, b, og, ty0, TT + HALO)
                th, sg = torch.tanh(y[..., :G]), torch.sigmoid(y[..., G:])
                tg = torch.arange(ty0, t0 + TT)
                valid = ((tg >= 0) & (tg < Tout))[None, :, None]
                gt = torch.zeros(BN, TT + HALO, G)
                sel = torch.nonzero(valid[0, :, 0]).flatten()
                gt[:, sel] = g[:, offs[ki] + tg[sel], og * G:og * G + G]
                dy = torch.cat([gt * sg * (1 - th * th), gt * th * sg * (1 - sg)], -1)
                dy = dy * valid
                yb = dy[:, HALO - KZ:]  # rows kZ + t - t0 for t in [t0 - 8, t0 + TT)
                xt = xs(ty0, TT + HALO + 8)
                db_rows = yb[:, KZ:KZ + TT]
                dbs[ki][rows_og] += db_rows.sum((0, 1))
                for cc in range(ngroups):
                    c1 = cc * G
                    dxt = torch.zeros(BN, TT, G)
                    for kk in range(k):
                        dxt += yb[:, KZ - kk:KZ - kk + TT] @ w[rows_og][:, c1:c1 + G, kk]
                        dws[ki][rows_og, c1:c1 + G, kk] += torch.einsum(
                            "btO,btc->Oc", db_rows, xt[:, HALO + kk:HALO + kk + TT, c1:c1 + G])
                    n = max(0, min(TT, GT - t0))
                    dx_acc[:, c1:c1 + G, t0:t0 + n] += dxt[:, :n].transpose(1, 2)
    grads = {"x": dx_acc.reshape(GB, GN, GC, GT)}
    for k, dw, db in zip(KS, dws, dbs):
        grads[f"w{k}"], grads[f"b{k}"] = dw.unsqueeze(2), db
    return out.reshape(GB, GN, 3 * GT - 12, GC), grads


def test_tiled_gtu_schedule_matches_jax():
    """C = 48 in three channel groups and three contraction chunks of 16,
    T = 64 in four time tiles of 16 (each backward tile with its 16-step
    halo, the first one's before t = 0): every multi-tile branch runs."""
    assert GC // G == 3 and GC // CK == 3 and GT // TT == 4
    a = _gtu_arrays()
    j_out, j_grads = _jax_gtu(a)
    out, grads = _tiled_gtu(a)
    _close(out, j_out, FWD_TOL, "out")
    for name, want in j_grads.items():
        _close(grads[name], want, GRAD_TOL, name)
