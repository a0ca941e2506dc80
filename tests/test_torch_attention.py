"""Spatial-attention export of the port against the JAX package's, on the
CPU: DSTAGNN ``forward(return_attention=True)`` against JAX
``apply(return_attention=True)`` on every spatial path (forward 2e-4 of
scale, shapes equal, scalar zeros where a kernel never materialises the
map), the zoo families' empty lists, and the evaluate CLI end to end with
``--export-attention`` (the files ``tests/test_attention_export.py``
checks for the JAX CLI). The JAX Pallas kernels run in interpret mode, the
port's kernel modules their plain versions."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.config import load_config as jax_load_config
from dstagnn_drought_tpu.models.dstagnn import ModelSpec as JaxSpec
from dstagnn_drought_tpu.models.dstagnn import apply as jax_apply
from dstagnn_drought_tpu.models.dstagnn import import_torch_state_dict
from dstagnn_drought_tpu.models.dstagnn import make_model as jax_make_model
from dstagnn_drought_tpu_torch.models.dstagnn import (
    DSTAGNN,
    ModelSpec,
    constants_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)

N = 16
KW = dict(num_of_vertices=N, len_input=12, num_for_predict=5, num_of_d=1, nb_block=2,
          in_channels=1, K=2, nb_chev_filter=8, nb_time_filter=8, d_model=24, d_k=8,
          n_heads=2)

# path: (graph: None | "ell" | "bell", tile-resident masks, flags)
PATHS = {
    "dense": (None, False, {}),
    "dense_kernel": (None, False, dict(use_pallas=True)),
    "fused_spatial": (None, False, dict(fuse_spatial=True)),
    "ell": ("ell", False, {}),
    "bell_plain": ("bell", False, {}),
    "bell_kernel": ("bell", False, dict(use_pallas=True)),
    "bell_tiles": ("bell", True, dict(use_pallas=True)),
}
# the map JAX exports on each path, (B=2, K=2, ...)
SHAPES = {"dense": (2, 2, N, N), "dense_kernel": (2, 2, N, N), "fused_spatial": (),
          "bell_plain": (2, 2, 2, None, 8, 8), "bell_kernel": (), "bell_tiles": ()}


@pytest.mark.parametrize("path", list(PATHS))
def test_maps_match_jax(path):
    from dstagnn_drought_tpu.ops.block_sparse import block_ell_from_adjacency as jax_bell
    from dstagnn_drought_tpu.ops.sparse import ell_from_adjacency as jax_ell
    from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency
    from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency

    graph, tiles, flags = PATHS[path]
    rng = np.random.default_rng(11)
    A = (rng.random((N, N)) < 0.2).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.5) & (A > 0)).astype(np.float32)
    np.fill_diagonal(pa, 1)
    x = rng.normal(size=(2, N, 1, 12)).astype(np.float32)
    jspec, spec = JaxSpec(**KW), ModelSpec(**KW)
    jg = pg = None
    if graph == "bell":
        jg, pg = jax_bell(A, block_size=8), block_ell_from_adjacency(A, block_size=8)
    elif graph == "ell":
        jg, pg = jax_ell(A), ell_from_adjacency(A)
    params, consts = jax_make_model(jax.random.PRNGKey(2), jspec, A, pa,
                                    **({"bell": jg} if tiles else {}))
    j_out, j_maps = jax_apply(params, jnp.asarray(x), spec=jspec, adj_pa=consts["adj_pa"],
                              cheb_polys=consts["cheb_polys"], deterministic=True, ell=jg,
                              bell_tiles=consts.get("bell_tiles"), return_attention=True,
                              **flags)

    model = DSTAGNN(spec, bell=pg if tiles else None)
    model.load_state_dict(params_from_jax(params, spec))
    c = constants_from_jax(consts)
    with torch.no_grad():
        out, maps = model(torch.from_numpy(x), adj_pa=c["adj_pa"],
                          cheb_polys=c["cheb_polys"], deterministic=True,
                          bell=pg if graph == "bell" else None,
                          ell=pg if graph == "ell" else None,
                          bell_tiles=c.get("bell_tiles"), return_attention=True, **flags)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-4, rtol=2e-4)
    assert len(maps) == len(j_maps) == KW["nb_block"]
    for m, jm in zip(maps, j_maps):
        jm = np.asarray(jm)
        assert tuple(m.shape) == jm.shape
        want = SHAPES.get(path)
        if want is not None:
            assert len(jm.shape) == len(want)
            assert all(w is None or w == s for w, s in zip(want, jm.shape))
        if jm.ndim == 0:
            assert float(m) == 0.0 and float(jm) == 0.0
            continue
        scale = max(1.0, float(np.abs(jm).max()))
        assert float(np.abs(m.numpy() - jm).max()) <= 2e-4 * scale


@pytest.mark.parametrize("name", ["astgcn", "mstgcn", "stgcn", "transformer"])
def test_zoo_families_export_no_maps(name):
    from dstagnn_drought_tpu_torch.models import get_family

    family = get_family(name)
    spec = ModelSpec(num_of_vertices=6, len_input=12, num_for_predict=4, num_of_d=1,
                     nb_block=2, in_channels=1, K=2, nb_chev_filter=4, nb_time_filter=4,
                     d_model=8, d_k=4, n_heads=2)
    A = np.eye(6, k=1) + np.eye(6, k=-1)
    model, c = family.make_model(spec, A, A, seed=0, device="cpu")
    x = torch.randn(2, 6, 1, 12)
    with torch.no_grad():
        out, maps = model(x, adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                          return_attention=True)
        plain = model(x, adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"])
    assert maps == [] and torch.equal(out, plain)


def test_evaluate_cli_exports_attention(toy_project, tmp_path):
    """Train one epoch with the port's CLI, then evaluate the latest
    checkpoint with --export-attention on the CPU: the JAX test's files,
    and the maps equal to JAX's Trainer.attention_maps on the same weights."""
    from dstagnn_drought_tpu.cli import prepare_data
    from dstagnn_drought_tpu.training.loop import Trainer as JaxTrainer
    from dstagnn_drought_tpu_torch.cli import evaluate, train
    from dstagnn_drought_tpu_torch.config import load_config

    root = toy_project
    conf = str(root / "TOY.conf")
    exp = str(tmp_path / "exp")
    prepare_data.main(["--config", conf])
    train.main(["--config", conf, "--experiments-root", exp, "--epochs", "1",
                "--device", "cpu"])
    report = evaluate.main(["--config", conf, "--experiments-root", exp, "--device", "cpu",
                            "--export-attention", "--attention-sample", "3"])
    assert np.isfinite(report["overall"]["mae"])
    run_dir = os.path.join(exp, "TOY", os.listdir(os.path.join(exp, "TOY"))[0])
    npz = np.load(os.path.join(run_dir, "attention_test.npz"))
    assert set(npz.files) == {"block_0", "block_1"}
    assert npz["block_0"].shape == (2, 12, 12)
    assert np.all(np.isfinite(npz["block_0"]))
    csv = np.loadtxt(os.path.join(run_dir, "attention_test.csv"), delimiter=",")
    np.testing.assert_allclose(csv, npz["block_0"][0], rtol=1e-6)
    assert os.path.exists(os.path.join(run_dir, "attention_test.png"))
    assert os.path.exists(os.path.join(run_dir, "output_epoch_0_test.npz"))

    state = torch.load(os.path.join(run_dir, "epoch_0.pt"), weights_only=True)
    jtr = JaxTrainer(jax_load_config(conf), experiments_root=str(tmp_path / "jax"))
    jtr.params = import_torch_state_dict(state["model"], jtr.spec)
    j_maps = jtr.attention_maps("test", 3)
    cfg = load_config(conf)
    assert cfg.training.nb_block == len(j_maps)
    for i, jm in enumerate(j_maps):
        scale = max(1.0, float(np.abs(jm).max()))
        assert float(np.abs(npz[f"block_{i}"] - jm).max()) <= 2e-4 * scale


def test_attention_sample_is_clamped(toy_project, tmp_path):
    """Trainer.attention_maps takes sample min(sample, n - 1), as JAX does."""
    from dstagnn_drought_tpu.cli import prepare_data
    from dstagnn_drought_tpu_torch.config import load_config
    from dstagnn_drought_tpu_torch.training.loop import Trainer

    prepare_data.main(["--config", str(toy_project / "TOY.conf")])
    tr = Trainer(load_config(toy_project / "TOY.conf"), device="cpu",
                 experiments_root=str(tmp_path))
    n = len(tr.dataset.test)
    last = tr.attention_maps("test", n - 1)
    for a, b in zip(tr.attention_maps("test", 10 ** 6), last):
        np.testing.assert_array_equal(a, b)
    assert last[0].shape == (2, 12, 12)
