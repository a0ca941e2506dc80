"""The port's node-partitioned spatial convs on P = 2 and 4 gloo ranks
against the JAX package's partitioned functions on a (1, P) mesh of its
virtual CPU devices (Pallas in interpret mode) and against the port's
single-rank conv, on the same numpy-seeded inputs: the ELL all-gather and
targeted-halo convs, the dense-mask BELL conv, and the tile-resident BELL
conv and its overlapped variant (one run each, held against JAX's t- and
c-layout: the port's kernels have one layout). The targeted-halo and BELL
convs take and return a rank's node rows (Np/P of them), as the model
hands them over: the test cuts whole inputs to the rank's rows and
gathers the output with ``comm.enter``/``comm.leave`` itself. The gathered
output, the gradients of x, emb, Θ, wq, wk and the masks; in bf16 against
the single-rank conv within 1e-2 of scale. At N = 29 the
BELL plans need no inert pad tiles; at N = 37 (5 tiles: 6 over 2 ranks, 8
over 4) they do, and there the port is held to its single-rank conv only:
JAX's partitioned tile conv returns NaN for dq (so demb and dwq) on such a
plan. Then the pad entries of an overlap sublist on the plain versions of
F, K1 and K2.

One module-scoped spawn a world size serves every case (the ranks import
this file, which imports JAX only inside the tests). JAX's side runs under
``jax.jit``, every case at P = 2 and each layout once at P = 4
(``JAX_AT_4``)."""
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu_torch.ops import sparse as psp
from dstagnn_drought_tpu_torch.ops.block_sparse import (
    active_tile_values,
    block_ell_from_adjacency,
    build_bell_tile_constants,
)
from dstagnn_drought_tpu_torch.ops.cuda import bell_bwd, bell_fused
from dstagnn_drought_tpu_torch.ops.cuda.bell_fused import (
    bell_cheb_conv_tiles,
    bell_cheb_conv_with_sat_pallas,
)
from dstagnn_drought_tpu_torch.parallel import bell_partition as bp
from dstagnn_drought_tpu_torch.parallel import comm
from dstagnn_drought_tpu_torch.parallel import graph_partition as gp
from dstagnn_drought_tpu_torch.parallel.launch import spawn
from dstagnn_drought_tpu_torch.parallel.mesh import make_mesh

N, BS, K, C, T, CO, B, D_MODEL, D_K = 29, 8, 2, 4, 32, 4, 2, 12, 4
N_INERT = 37  # a node count whose BELL plans pad with inert tiles
FWD_TOL, GRAD_TOL = 2e-4, 5e-3  # of scale: max |Δ| over max(1, max |reference|)
GRADS = ("x", "emb", "thetas", "wq", "wk", "masks")
# the port's convs; the port's kernels have one layout, so one run of a
# tile path is held against both of JAX's (``tiles_t``/``tiles_c``: JAX's
# t- and c-layout; the inert and bf16 cases compare with the port only)
PORT_CASES = ("gather", "halo", "bell", "tiles", "overlap")
CASES = ("gather", "halo", "bell", "tiles_t", "tiles_c", "overlap_t", "overlap_c")
INERT_CASES = ("bell", "tiles_t", "overlap_t")
BF16_CASES = ("halo", "bell", "tiles_t", "overlap_t")  # the model's bf16 operands
BF16_TOL = 1e-2  # of scale
# JAX's side at P = 4 (every case at P = 2): each layout of each tile path
# once, which keeps the module's interpret-mode compiles within its budget
JAX_AT_4 = ("gather", "halo", "bell", "tiles_c", "overlap_t")


def _inputs(N=N):
    rng = np.random.default_rng(0)
    A = (rng.random((N, N)) < 0.15).astype(np.float32)
    i = np.arange(N)
    A = np.maximum(A, (np.abs(i[:, None] - i[None, :]) == 1)).astype(np.float32)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.5) & (A > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(A=A, pa=pa, cheb=f(K, N, N), masks=f(K, N, N), thetas=f(K, C, CO, scale=0.3),
                wq=f(D_MODEL, K * D_K, scale=0.3), wk=f(D_MODEL, K * D_K, scale=0.3),
                x=f(B, N, C, T), emb=f(B, N, D_MODEL), cot=f(B, N, CO, T))


def _port(case):
    """The port's conv of a case (``tiles_t`` → ``tiles``)."""
    return case.split("_")[0]


def _pad_nodes(a, n_pad, axes):
    pad = [(0, 0)] * a.ndim
    for ax in axes:
        pad[ax] = (0, n_pad - a.shape[ax])
    return np.pad(a, pad)


def _structures(d, P):
    ell = gp.shard_ell(psp.ell_from_adjacency(d["A"]), P)
    bell = block_ell_from_adjacency(d["A"], block_size=BS)
    plan = bp.build_bell_tile_shard_plan(bell, P, d["pa"], d["cheb"])
    return ell, bell, plan


def _port_case(case, d, mesh, ell, bell, plan, dtype=torch.float32):
    """(output, gradients) of one case on this rank's mesh, every floating
    operand in ``dtype``; ``masks`` is the rank's mask slice on the tile
    paths."""
    P, N = mesh.graph, d["x"].shape[1]
    n_pad = ell.num_nodes
    if case in ("gather", "halo"):
        x, emb = d["x"], d["emb"]
        if case == "gather":
            x, emb = _pad_nodes(x, n_pad, (1,)), _pad_nodes(emb, n_pad, (1,))
        masks = d["masks"]
    elif case == "bell":
        x, emb, masks = d["x"], d["emb"], d["masks"]
    else:
        x, emb = d["x"], d["emb"]
        masks = plan.pack_active(active_tile_values(d["masks"], bell))[mesh.g]
    ts = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in
          dict(x=x, emb=emb, thetas=d["thetas"], wq=d["wq"], wk=d["wk"], masks=masks).items()}
    kw = dict(thetas=ts["thetas"], wq=ts["wq"], wk=ts["wk"], n_heads=K, d_k=D_K)
    pa, cheb = (torch.tensor(d[k], dtype=dtype) for k in ("pa", "cheb"))  # as the model
    bell_plan = bp.build_bell_shard_plan(bell, P)
    n_rows = {"gather": n_pad, "halo": n_pad, "bell": bell_plan.padded_nodes}.get(
        case, plan.padded_nodes)
    # the rank's node rows of the whole inputs (backward: all-gather)
    emb_l, x_l = (comm.enter(gp.pad_nodes(ts[k], 1, n_rows), 1, mesh.graph_group)
                  for k in ("emb", "x"))
    if case in ("gather", "halo"):
        edges = dict(cheb_edges=psp.gather_edge_values(cheb, ell),
                     bias_edges=psp.gather_edge_values(pa[None] * ts["masks"], ell))
        if case == "gather":
            out = gp.partitioned_sparse_conv(mesh, ts["emb"], ts["x"], ell, **edges, **kw)
        else:
            out = gp.halo_partitioned_sparse_conv(mesh, emb_l, x_l, gp.build_halo_plan(ell, P),
                                                  **edges, **kw)
    elif case == "bell":
        out = bp.partitioned_bell_conv(mesh, emb_l, x_l, bell_plan, adj_pa=pa, masks=ts["masks"],
                                       cheb_polys=cheb, **kw)
    elif case == "overlap":
        out = bp.partitioned_bell_tiles_conv_overlap(
            mesh, emb_l, x_l, plan, bp.build_overlap_lists(plan), mask_tiles=ts["masks"], **kw)
    else:
        out = bp.partitioned_bell_tiles_conv(mesh, emb_l, x_l, plan, mask_tiles=ts["masks"],
                                             **kw)
    if case != "gather":  # local rows in, local rows out
        assert out.shape[1] == n_rows // P == x_l.shape[1]
        out = comm.leave(out, 1, mesh.graph_group)
    out = out[:, :N]
    (out.float() * torch.tensor(d["cot"])).sum().backward()
    grads = {k: t.grad.float().numpy()[:, :N] if k in ("x", "emb") else t.grad.float().numpy()
             for k, t in ts.items()}
    return out.detach().float().numpy(), grads


def conv_rank(rank, P):
    """One gloo rank: every case on the (1, P) mesh, and the inert-tile
    cases at N_INERT."""
    mesh = make_mesh(1, P)
    out = {}
    for n, cases in ((N, PORT_CASES), (N_INERT, map(_port, INERT_CASES))):
        d = _inputs(n)
        structures = _structures(d, P)
        out.update({(case, n): _port_case(case, d, mesh, *structures) for case in cases})
    d = _inputs()
    structures = _structures(d, P)
    out.update({(case, "bf16"): _port_case(case, d, mesh, *structures, dtype=torch.bfloat16)
                for case in map(_port, BF16_CASES)})
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    P = request.param
    return P, spawn(conv_rank, P, P, timeout=240, init_dir=str(tmp_path_factory.mktemp("init")))


def _single(case, d, dtype=torch.float32):
    """The port's single-rank conv of ``case`` (output, gradients), every
    floating operand in ``dtype``."""
    ell = psp.ell_from_adjacency(d["A"])
    bell = block_ell_from_adjacency(d["A"], block_size=BS)
    ts = {k: torch.tensor(d[k], dtype=dtype, requires_grad=True) for k in GRADS}
    pa, cheb = (torch.tensor(d[k], dtype=dtype) for k in ("pa", "cheb"))  # as the model
    if case in ("gather", "halo"):
        s = psp.sparse_spatial_attention_scores(ts["emb"], ell, wq=ts["wq"], wk=ts["wk"],
                                                n_heads=K, d_k=D_K)
        out = psp.sparse_cheb_conv_with_sat(
            ts["x"], s, ell, cheb_edges=psp.gather_edge_values(cheb, ell),
            bias_edges=psp.gather_edge_values(pa[None] * ts["masks"], ell), thetas=ts["thetas"])
    elif case == "bell":
        out = bell_cheb_conv_with_sat_pallas(ts["x"], ts["emb"], bell, wq=ts["wq"], wk=ts["wk"],
                                             adj_pa=pa, masks=ts["masks"], cheb_polys=cheb,
                                             thetas=ts["thetas"], n_heads=K, d_k=D_K)
    else:
        tiles = build_bell_tile_constants(bell, d["pa"], d["cheb"])
        ts["masks"] = torch.tensor(active_tile_values(d["masks"], bell), dtype=dtype,
                                   requires_grad=True)
        out = bell_cheb_conv_tiles(ts["x"], ts["emb"], bell, wq=ts["wq"], wk=ts["wk"],
                                   mask_tiles=ts["masks"], pattern_tiles=tiles["pattern_tiles"],
                                   pa_tiles=tiles["pa_tiles"], cheb_tiles=tiles["cheb_tiles"],
                                   thetas=ts["thetas"], n_heads=K, d_k=D_K)
    (out.float() * torch.tensor(d["cot"])).sum().backward()
    return out.detach().float().numpy(), {k: t.grad.float().numpy() for k, t in ts.items()}


def _jax(case, d, P):
    """JAX's partitioned function of ``case`` on a (1, P) mesh of virtual
    CPU devices: (output, gradients)."""
    import jax
    import jax.numpy as jnp

    from dstagnn_drought_tpu.ops import block_sparse as jbs
    from dstagnn_drought_tpu.ops import sparse as jsp
    from dstagnn_drought_tpu.parallel import bell_partition as jbp
    from dstagnn_drought_tpu.parallel import graph_partition as jgp
    from dstagnn_drought_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(1, P, devices=jax.devices()[:P])
    ell = jgp.shard_ell(jsp.ell_from_adjacency(d["A"]), P)
    bell = jbs.block_ell_from_adjacency(d["A"], block_size=BS)
    plan = jbp.build_bell_tile_shard_plan(bell, P, d["pa"], d["cheb"])
    n_pad = ell.num_nodes
    pa, cheb = jnp.asarray(d["pa"]), jnp.asarray(d["cheb"])
    x, emb, masks = d["x"], d["emb"], d["masks"]
    if case == "gather":
        x, emb = _pad_nodes(x, n_pad, (1,)), _pad_nodes(emb, n_pad, (1,))
    elif case.startswith(("tiles", "overlap")):
        masks = plan.pack_active(jbs.active_tile_values(masks, bell))

    def f(x, emb, thetas, wq, wk, masks):
        kw = dict(thetas=thetas, wq=wq, wk=wk, n_heads=K, d_k=D_K)
        if case in ("gather", "halo"):
            edges = dict(cheb_edges=jsp.gather_edge_values(cheb, ell),
                         bias_edges=jsp.gather_edge_values(pa[None] * masks, ell))
            if case == "gather":
                out = jgp.partitioned_sparse_conv(mesh, emb, x, ell, **edges, **kw)[:, :N]
            else:
                out = jgp.halo_partitioned_sparse_conv(mesh, emb, x, jgp.build_halo_plan(ell, P),
                                                       **edges, **kw)
        elif case == "bell":
            out = jbp.partitioned_bell_conv(mesh, emb, x, jbp.build_bell_shard_plan(bell, P),
                                            adj_pa=pa, masks=masks, cheb_polys=cheb, **kw)
        elif case.startswith("overlap"):
            out = jbp.partitioned_bell_tiles_conv_overlap(
                mesh, emb, x, plan, jbp.build_overlap_lists(plan), mask_tiles=masks,
                layout=case[-1], **kw)
        else:
            out = jbp.partitioned_bell_tiles_conv(mesh, emb, x, plan, mask_tiles=masks,
                                                  layout=case[-1], **kw)
        return (out * d["cot"]).sum(), out

    args = [jnp.asarray(a) for a in (x, emb, d["thetas"], d["wq"], d["wk"], masks)]
    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(6)), has_aux=True))(*args)
    grads = dict(zip(GRADS, (np.asarray(g) for g in grads)))
    grads["x"], grads["emb"] = grads["x"][:, :N], grads["emb"][:, :N]
    return np.asarray(out), grads


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: max |Δ| {err}"


def _check(P, results, case, n, refs, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL):
    """Every rank's gathered output and whole gradients alike; the output
    and the gradients (the masks stacked over ranks on the tile paths)
    against each (name, output, gradients) of ``refs``."""
    d = _inputs(N if n == "bf16" else n)
    outs = [r[(_port(case), n)][0] for r in results]
    grads = [r[(_port(case), n)][1] for r in results]
    for r in range(1, P):
        np.testing.assert_array_equal(outs[r], outs[0])
        for k in GRADS[:5]:
            np.testing.assert_array_equal(grads[r][k], grads[0][k], err_msg=k)
    tiles = case.startswith(("tiles", "overlap"))
    mine = dict(grads[0], masks=np.stack([g["masks"] for g in grads]) if tiles
                else grads[0]["masks"])
    for name, out, ref_grads in refs:
        if tiles and name == "single rank":
            bell = block_ell_from_adjacency(d["A"], block_size=BS)
            plan = bp.build_bell_tile_shard_plan(bell, P, d["pa"], d["cheb"])
            ref_grads = dict(ref_grads, masks=plan.pack_active(ref_grads["masks"]))
        _close(outs[0], out, fwd_tol, f"{case} output vs {name}")
        for k in GRADS:
            _close(mine[k], ref_grads[k], grad_tol, f"{case} d{k} vs {name}")


@pytest.mark.parametrize("case", CASES)
def test_partitioned_conv_matches_jax_and_single_rank(ranks, case):
    P, results = ranks
    d = _inputs()
    refs = [("single rank", *_single(case, d))]
    if P == 2 or case in JAX_AT_4:
        refs.append(("jax", *_jax(case, d, P)))
    _check(P, results, case, N, refs)


@pytest.mark.parametrize("case", INERT_CASES)
def test_partitioned_conv_with_inert_tiles_matches_single_rank(ranks, case):
    """At N_INERT the plans pad each rank's tiles with inert tiles (a self
    slot whose scores are all −1e30): the port stays finite and equal to its
    single-rank conv."""
    P, results = ranks
    out, grads = results[0][(_port(case), N_INERT)]
    assert np.isfinite(out).all() and all(np.isfinite(g).all() for g in grads.values())
    _check(P, results, case, N_INERT, [("single rank", *_single(case, _inputs(N_INERT)))])


@pytest.mark.parametrize("case", BF16_CASES)
def test_partitioned_conv_in_bf16_matches_single_rank(ranks, case):
    """Every operand in bf16, as the model hands them over in bf16
    compute: the partitioned conv against the single-rank conv within 1e-2
    of scale."""
    P, results = ranks
    _check(P, results, case, "bf16", [("single rank", *_single(case, _inputs(),
                                                               torch.bfloat16))],
           BF16_TOL, BF16_TOL)


def test_pad_entries_contribute_exactly_zero():
    """An overlap sublist's pad tiles (one entry of zero pattern and zero
    Chebyshev value) on the plain F, K1 and K2: the pad entries' weights and
    the pad tiles' output rows are exactly 0, and dΘ and dx equal those of
    the same list without the pad entries (up to the plain einsums' order of
    summation; on the card, chip_smoke holds the kernels to bit equality); a
    tile whose scores are all −1e30 gives no NaN."""
    d = _inputs(N_INERT)
    _, bell, plan = _structures(d, 4)
    ov = bp.build_overlap_lists(plan)
    cases = [(r, s) for r in range(4) for s in "AB"
             if (ov.n_localA[r] if s == "A" else plan.tiles_per_shard - ov.n_localA[r])
             < getattr(ov, "tiles" + s).shape[1]]
    assert cases
    r, side = cases[0]
    pick = lambda name: getattr(ov, name + side)[r]
    ts, tc, a_src, a_tgt, sel = (pick(n) for n in ("tile_start", "tile_count", "a_src",
                                                     "a_tgt", "sel"))
    n_src = plan.tiles_per_shard if side == "A" else plan.ns_max
    n_true = ov.n_localA[r] if side == "A" else plan.tiles_per_shard - ov.n_localA[r]
    n = int(ts[-1] + tc[-1])
    m = int(ts[n_true]) if n_true < len(ts) else n
    full = bp.RankTiles(ts, tc, a_src[:n], a_tgt[:n], n_src, "cpu")
    ts2, tc2 = ts.copy(), tc.copy()
    ts2[n_true:], tc2[n_true:] = m, 0
    bare = bp.RankTiles(ts2, tc2, a_src[:m], a_tgt[:m], n_src, "cpu")
    zero = np.zeros((1, BS, BS), bool)
    pattern = torch.from_numpy(np.concatenate([plan.pattern_act[r], zero])[sel[:n]])
    assert not pattern[m:].any()  # the pad entries' patterns are empty
    g = torch.Generator().manual_seed(0)
    H, R = K, full.num_tiles
    q, k = (torch.randn(B, R * BS, H, D_K, generator=g) for _ in range(2))
    bias = torch.where(pattern[:, None], torch.randn(n, H, BS, BS, generator=g),
                       torch.tensor(-1e30))
    cheb = torch.randn(n, H, BS, BS, generator=g) * pattern[:, None]
    x = torch.randn(B, R * BS, C * T, generator=g)
    thetas = torch.randn(H, C, CO, generator=g)
    gm = torch.randn(B, R * BS, CO * T, generator=g)
    t = full.tensors
    out = bell_fused.bell_forward_plain(t["tile_start"], t["tile_count"], t["active_src"], q, k,
                                        bias, cheb, x, thetas)
    assert torch.isfinite(out).all()
    assert (out[:, n_true * BS:full.n_targets * BS] == 0).all()
    _, _, att = bell_fused.active_softmax(q, k, bias, t["active_src"], t["active_tgt"], R)
    w = cheb[None] * att * pattern[None, :, None]
    assert (w[:, m:] == 0).all()
    tb = bare.tensors
    for tiles_, w_ in ((full, w), (bare, w[:, :m])):
        tt = tiles_.tensors
        dA, dth = bell_bwd.bell_k1_plain(tt["active_src"], tt["active_tgt"], thetas, gm, x, w_)
        dx = bell_bwd.bell_k2_plain(tt["src_start"], tt["src_count"], tt["src_order"],
                                    tt["active_tgt"], thetas, gm, w_)
        if tiles_ is full:
            dth_full, dx_full = dth, dx
    torch.testing.assert_close(dth, dth_full, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, dx_full, rtol=1e-6, atol=1e-6)
    assert tb["tile_count"][n_true:].sum() == 0
