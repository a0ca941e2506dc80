"""The plain reference against the program's plain CPU path, at a small
size, on each cell's path: the forward alone, and a whole run's first steps
and last validation predictions (``runner.execute`` on the CPU)."""
import time

import numpy as np
import pytest
import torch

import tiny
from pbcore import check, runner, state
from pbcore.layers import module
from reference import dstagnn_ref as ref

CELLS = ("gambia.bell_tiles", "pems08.fused", "gambia.dense", "pems08.dense")
PEAKS = {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


RANDOM_GRAPH = {"kind": "random", "params": {"density": 0.1}}


@pytest.mark.parametrize("workload,graph", [(w, None) for w in CELLS]
                         + [("gambia.bell_tiles", RANDOM_GRAPH), ("pems08.dense", RANDOM_GRAPH)])
def test_forward_matches_program(workload, graph, tmp_path):
    """The reference's predictions from the program's own initial weights
    agree with the program's deterministic forward to float32 rounding, on
    each cell's graph and on the random graph kind no cell uses yet."""
    cell = tiny.cell(workload)
    if graph is not None:
        cell["traffic"]["graph"] = graph
    spec = cell["config"]["model"]
    inputs = runner.make_inputs(cell, 11)
    trainer, _ = runner.build(cell, 11, inputs, "cpu", str(tmp_path))
    x = torch.as_tensor(inputs["splits"]["val"][0][:4])
    with torch.no_grad():
        c = trainer.constants
        out = trainer.model(x, adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                            bell=c.get("bell"), bell_tiles=c.get("bell_tiles"),
                            use_pallas=cell["traffic"]["knobs"]["use_pallas"],
                            fuse_tat=cell["traffic"]["knobs"]["fuse_tat"],
                            fuse_spatial=cell["traffic"]["knobs"]["fuse_spatial"])
    weights = {n: p.detach() for n, p in trainer.model.named_parameters()}
    if inputs["tiles"] is not None:
        weights = state.tiles_to_masks(weights, inputs["tiles"])
    r = ref.forward(weights, x, spec, check.constants(inputs, spec, "cpu"))
    assert float((out - r).abs().max() / r.abs().max()) < 5e-6


@pytest.mark.parametrize("workload", CELLS)
def test_run_on_cpu_agrees(workload):
    """A whole run on the CPU (warm-up, a window of one epoch, the
    reference's comparison) reads float32 rounding on every number."""
    cell = tiny.cell(workload)
    rec = runner.execute(cell, 2 ** 31 + 5, 0.0, False, "cpu", time.perf_counter(), PEAKS)
    n = rec["numbers"]
    assert len(rec["epochs"]) == 1 and rec["train_steps"] == rec["epochs"][0]["train_steps"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5 and n["val_gap"] < 1e-5
    assert n["change_gap"] < 5e-3
    assert "BlockList.1.EmbedT.pos_embed.weight" in n["where"]["left_out"]


def test_cheb_polys_follow_the_recurrence():
    """T_0 = I, T_1 = 2L/λ - I with λ the power-iteration estimate, T_2 the
    elementwise recurrence; λ within 1e-3 of the true eigenvalue on a
    raster."""
    adj = module("graphs", "grid").make(30, nodes_x=6, nodes_y=5)
    p = ref.cheb_polys(adj, 3).double()
    lap = torch.diag(torch.as_tensor(adj).double().sum(1)) - torch.as_tensor(adj).double()
    lam = ref.lambda_max(lap)
    assert abs(lam - float(torch.linalg.eigvalsh(lap).max())) < 1e-3 * lam
    lt = 2 * lap / lam - torch.eye(30, dtype=torch.float64)
    assert torch.allclose(p[0], torch.eye(30, dtype=torch.float64))
    assert torch.allclose(p[1], lt, atol=1e-6)
    assert torch.allclose(p[2], 2 * lt * lt - torch.eye(30, dtype=torch.float64), atol=1e-6)


def test_tiles_round_trip():
    """The tile support holds every edge and self loop; dense → tiles →
    dense is exact on the support."""
    adj = module("graphs", "grid").make(30, nodes_x=6, nodes_y=5)
    tiles = state.Tiles(adj, 8)
    dense = torch.randn(30, 30)
    back = tiles.to_dense(tiles.to_tiles(dense))
    support = back != 0
    assert bool(support[torch.as_tensor(adj) != 0].all()) and bool(support.diagonal().all())
    assert torch.equal(back[support], dense[support])


def test_inputs_repeat_from_the_seed():
    cell = tiny.cell("pems08.dense")
    a, b = runner.make_inputs(cell, 2 ** 33 + 1), runner.make_inputs(cell, 2 ** 33 + 1)
    for name in ("train", "val"):
        assert np.array_equal(a["splits"][name][0], b["splits"][name][0])
    assert np.array_equal(a["adj"], b["adj"]) and np.array_equal(a["adj_pa"], b["adj_pa"])
    assert a["adj"].sum() == 2 * 16 and np.array_equal(a["adj"], a["adj"].T)


@pytest.mark.parametrize("n,density", [(30, 0.1), (2139, 0.01)])
def test_random_graph(n, density):
    """Symmetric, no self loops, about ``density`` of the pairs linked, and
    the same from the same generator state."""
    import numpy as np

    make = module("graphs", "random").make
    a = make(n, density=density, rng=np.random.default_rng(7))
    assert np.array_equal(a, make(n, density=density, rng=np.random.default_rng(7)))
    assert np.array_equal(a, a.T) and not a.diagonal().any()
    pairs = a.sum() / 2 / (n * (n - 1) / 2)
    assert abs(pairs - density) < 5 * (density / (n * (n - 1) / 2)) ** 0.5 + 1e-3
