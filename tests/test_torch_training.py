"""The port's training path against the JAX package's, on the CPU: the
windowed npz, a 5-step loss trajectory from the same weights and batches,
and the CLI end to end with ``--device cpu``."""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from dstagnn_drought_tpu.data.dataset import ArrayDataset as JaxDataset
from dstagnn_drought_tpu.data.dataset import Split as JaxSplit
from dstagnn_drought_tpu.data.windowing import (
    read_and_generate_dataset as jax_read_and_generate,
)
from dstagnn_drought_tpu.models.dstagnn import ModelSpec as JaxSpec
from dstagnn_drought_tpu.models.dstagnn import apply as jax_apply
from dstagnn_drought_tpu.models.dstagnn import make_model as jax_make_model
from dstagnn_drought_tpu.training.step import make_optimizer as jax_optimizer
from dstagnn_drought_tpu.training.step import make_train_step
from dstagnn_drought_tpu_torch.cli import train as train_cli
from dstagnn_drought_tpu_torch.config import load_config
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.data.windowing import read_and_generate_dataset
from dstagnn_drought_tpu_torch.models.dstagnn import (
    DSTAGNN,
    ModelSpec,
    constants_from_jax,
    params_from_jax,
    permute_nodes,
)
from dstagnn_drought_tpu_torch.ops.cuda import gtu_fused, tat_fused
from dstagnn_drought_tpu_torch.training import loop
from dstagnn_drought_tpu_torch.training.step import make_optimizer, train_step

torch.set_num_threads(1)


def test_windowed_npz_bit_identical(tmp_path):
    rng = np.random.default_rng(5)
    sig = rng.normal(size=(120, 6, 2)) * 10 + 50
    paths = []
    for side, fn in (("port", read_and_generate_dataset), ("jax", jax_read_and_generate)):
        d = tmp_path / side
        d.mkdir()
        np.savez(d / "SIG.npz", data=sig)
        fn(str(d / "SIG.npz"), 0, 1, 2, 12, points_per_hour=2, save=True)
        paths.append(d / "SIG_r2_d1_w0_dstagnn.npz")
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_five_step_trajectory_matches_jax():
    """Same weights, same batch plan, dropout 0: per-step SmoothL1 + Adam
    losses agree to rtol 2e-3 / atol 2e-4 (precedent
    tests/test_parity_torch.py::test_training_trajectory_parity)."""
    _five_step_trajectory()


def test_five_step_fused_trajectory_matches_jax():
    """The same trajectory with fuse_tat and fuse_spatial on both sides (the
    JAX kernels in interpret mode, the port's plain versions)."""
    _five_step_trajectory(fuse_tat=True, fuse_spatial=True)


def test_five_step_fuse_gtu_trajectory_matches_jax():
    """The same trajectory with fuse_gtu at T=48, C=16 (inside the fused
    GTU gate) on both sides."""
    _five_step_trajectory(T=48, C=16, fuse_gtu=True)


def _five_step_trajectory(T=12, C=8, **flags):
    rng = np.random.default_rng(8)
    N, P, lr, bs = 10, 4, 1e-3, 4
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=P, num_of_d=1,
              nb_block=2, in_channels=1, K=3, nb_chev_filter=C, nb_time_filter=C,
              d_model=16, d_k=8, n_heads=2, dropout_rate=0.0)
    A = (rng.random((N, N)) < 0.3).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = (rng.random((N, N)) < 0.3).astype(np.float32)
    x = rng.normal(size=(18, N, 1, T)).astype(np.float32)
    y = rng.normal(size=(18, N, P)).astype(np.float32)
    jspec = JaxSpec(**kw)
    params, consts = jax_make_model(jax.random.PRNGKey(2), jspec, A, pa)
    spec = ModelSpec(**kw)
    model = DSTAGNN(spec)
    model.load_state_dict(params_from_jax(params, spec))  # before JAX donates them

    # the batch plan of the first 5 steps of epoch 0, padded tail masked
    split = Split(x, y)
    ds = ArrayDataset(split, split, split, np.zeros(1), np.ones(1))
    idx, n_valid = ds.batch_indices("train", bs, shuffle=True, seed=1 * 100003 + 0)
    j_idx, _ = JaxDataset(JaxSplit(x, y), JaxSplit(x, y), JaxSplit(x, y),
                          np.zeros(1), np.ones(1)).batch_indices(
        "train", bs, shuffle=True, seed=1 * 100003 + 0)
    np.testing.assert_array_equal(idx, j_idx)
    weights = (np.arange(idx.size) < n_valid).astype(np.float32).reshape(idx.shape)
    assert weights[-1].sum() < bs  # the padded tail is among the steps

    opt = jax_optimizer(lr)
    step = make_train_step(jspec, opt, apply_fn=functools.partial(jax_apply, **flags))
    p, s, key = params, opt.init(params), jax.random.PRNGKey(0)
    jax_losses = []
    for b in range(idx.shape[0]):
        p, s, key, loss = step(p, s, key, x, y, idx[b], consts, weights[b])
        jax_losses.append(float(loss))

    c = constants_from_jax(consts)
    optimizer = make_optimizer(model.parameters(), lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for b in range(idx.shape[0]):
        i = torch.from_numpy(idx[b].astype(np.int64))
        losses.append(float(train_step(model, optimizer, xt[i], yt[i], c,
                                       weights=torch.from_numpy(weights[b]), **flags)))
    assert len(losses) == 5
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
    assert abs(losses[0] - losses[-1]) > 1e-4  # the trajectory moves


@pytest.fixture()
def toy_windowed(toy_project):
    """The toy project's windowed npz, written by the port's pipeline."""
    cfg = load_config(toy_project / "TOY.conf")
    read_and_generate_dataset(cfg.data.graph_signal_matrix_filename, 0, 0, 1,
                              cfg.data.num_for_predict, 1, save=True)
    return toy_project


def test_cli_trains_checkpoints_and_resumes(toy_windowed, tmp_path, capsys):
    conf = str(toy_windowed / "TOY.conf")
    exp = tmp_path / "exp"
    result = train_cli.main(["--config", conf, "--experiments-root", str(exp),
                             "--device", "cpu", "--epochs", "2"])
    assert "horizon" in capsys.readouterr().out
    run_dir = next((exp / "TOY").iterdir())
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_losses = [e["train_loss"] for e in events if e["event"] == "epoch"]
    assert len(train_losses) == 2 and train_losses[1] < train_losses[0]
    assert (run_dir / f"epoch_{result['best_epoch']}.pt").exists()
    with np.load(run_dir / f"output_epoch_{result['best_epoch']}_test.npz") as d:
        assert d["prediction"].shape == d["data_target_tensor"].shape
        assert np.isfinite(d["prediction"]).all()
    assert len(result["report"]["per_horizon"]) == 12

    cfg = load_config(conf)
    trainer = loop.Trainer(cfg, experiments_root=str(exp), device="cpu")
    assert trainer.resume()
    assert trainer.epoch == 2
    assert trainer.best_val == pytest.approx(result["best_val"])
    assert trainer.best_epoch == result["best_epoch"]
    # --resume continues from there: one more epoch only
    train_cli.main(["--config", conf, "--experiments-root", str(exp),
                    "--device", "cpu", "--epochs", "3", "--resume"])
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [0, 1, 2]


def test_cli_trains_the_fused_path(toy_windowed, tmp_path):
    """The CLI with the two INI keys fuse_tat and fuse_spatial on: both
    kernel modules' plain versions run on the CPU, no launch is counted."""
    from dstagnn_drought_tpu_torch.ops.cuda import block_spatial_fused, tat_fused

    text = (toy_windowed / "TOY.conf").read_text()
    conf = tmp_path / "FUSED.conf"
    conf.write_text(text + "fuse_tat = true\nfuse_spatial = true\n")
    calls = {"tat": 0, "spatial": 0}
    real = (tat_fused.tat_fused_plain, block_spatial_fused.spatial_middle_plain)

    def tat(*a, **k):
        calls["tat"] += 1
        return real[0](*a, **k)

    def spatial(*a, **k):
        calls["spatial"] += 1
        return real[1](*a, **k)

    exp = tmp_path / "exp"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tat_fused, "tat_fused_plain", tat)
        mp.setattr(block_spatial_fused, "spatial_middle_plain", spatial)
        result = train_cli.main(["--config", str(conf), "--experiments-root", str(exp),
                                 "--device", "cpu", "--epochs", "2"])
    cfg = load_config(conf)
    assert cfg.training.fuse_tat and cfg.training.fuse_spatial
    assert calls["tat"] == calls["spatial"] > 0
    assert calls["tat"] % cfg.training.nb_block == 0
    run_dir = next((exp / "TOY").iterdir())
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_losses = [e["train_loss"] for e in events if e["event"] == "epoch"]
    assert len(train_losses) == 2 and train_losses[1] < train_losses[0]
    assert np.isfinite(result["test_loss"])


def _long_conf(toy_project, tmp_path, extra=""):
    """The toy project at T=48, C=16 (num_of_hours=4 at one point an hour),
    its signal and windowed npz in ``tmp_path``."""
    import shutil

    shutil.copy(toy_project / "TOY.npz", tmp_path / "TOY.npz")
    text = (toy_project / "TOY.conf").read_text()
    for a, b in ((f"{toy_project}/TOY.npz", f"{tmp_path}/TOY.npz"),
                 ("len_input = 12", "len_input = 48"), ("num_of_hours = 1", "num_of_hours = 4"),
                 ("nb_chev_filter = 8", "nb_chev_filter = 16"),
                 ("nb_time_filter = 8", "nb_time_filter = 16")):
        assert a in text, a
        text = text.replace(a, b)
    conf = tmp_path / "LONG.conf"
    conf.write_text(text + extra)
    cfg = load_config(conf)
    read_and_generate_dataset(cfg.data.graph_signal_matrix_filename, 0, 0, 4,
                              cfg.data.num_for_predict, 1, save=True)
    return conf


def test_cli_trains_the_fuse_gtu_path(toy_project, tmp_path):
    """The CLI with the INI key fuse_gtu = true at T=48: every block's GTU
    tail goes through gtu_cat (its plain version on the CPU, counted by
    wrapping it), no launch is counted."""
    from dstagnn_drought_tpu_torch.ops.cuda import gtu_fused

    conf = _long_conf(toy_project, tmp_path, "fuse_gtu = true\n")
    calls = []
    real = gtu_fused.gtu_cat_plain
    before = (gtu_fused.fwd_launches, gtu_fused.bwd_launches)

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    exp = tmp_path / "exp"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gtu_fused, "gtu_cat_plain", counted)
        result = train_cli.main(["--config", str(conf), "--experiments-root", str(exp),
                                 "--device", "cpu", "--epochs", "2"])
    cfg = load_config(conf)
    assert cfg.training.fuse_gtu is True
    assert calls and len(calls) % cfg.training.nb_block == 0
    assert all(s[2:] == (16, 48) for s in calls)
    assert (gtu_fused.fwd_launches, gtu_fused.bwd_launches) == before
    run_dir = next((exp / "TOY").iterdir())
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_losses = [e["train_loss"] for e in events if e["event"] == "epoch"]
    assert len(train_losses) == 2 and all(np.isfinite(train_losses))
    assert np.isfinite(result["test_loss"])


def test_trainer_resolves_and_validates_fuse_gtu(toy_windowed, tmp_path):
    """"auto" resolves off; true at T=12 (outside the gate) raises a
    ValueError naming fuse_gtu, as the JAX trainer does."""
    cfg = load_config(toy_windowed / "TOY.conf")
    assert cfg.training.fuse_gtu == "auto"
    trainer = loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")
    assert trainer.fuse_gtu is False
    cfg.training.fuse_gtu = True
    with pytest.raises(ValueError, match="fuse_gtu"):
        loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")


def _fuse_gtu_config(toy_windowed, C, T):
    cfg = load_config(toy_windowed / "TOY.conf")
    cfg.training.fuse_gtu = True
    cfg.training.nb_time_filter, cfg.data.len_input = C, T
    return cfg


# (C, T, compute dtype, accepted on the card): GAMBIA's C = 32, T = 144 in
# both dtypes; C = 48 at T = 144, which the float32 CUDA-core backward
# refused before the kernels tiled C and T; C = 64 at T = 144 and at T =
# 48, which had no bf16 instantiation; and the shapes of ROADMAP's
# refusals: nb_time_filter 64 and 128 with one and two days of five-minute
# readings (T = 288, 576). Every one is accepted: JAX's gate is the only one.
FUSE_GTU_CARD_CASES = [
    (32, 144, torch.bfloat16, True), (32, 144, torch.float32, True),
    (48, 144, torch.bfloat16, True), (48, 144, torch.float32, True),
    (64, 144, torch.bfloat16, True), (64, 48, torch.bfloat16, True),
    (64, 288, torch.float32, True), (64, 576, torch.bfloat16, True),
    (128, 288, torch.bfloat16, True), (128, 576, torch.float32, True),
]


@pytest.mark.parametrize("C, T, dtype, fits", FUSE_GTU_CARD_CASES)
def test_resolve_fuse_gtu_checks_the_card_budget(toy_windowed, C, T, dtype, fits):
    """resolve_fuse_gtu keeps JAX's gate only: a shape it admits resolves
    on, and the kernels' own gate (``gtu_fused.limit_error``) admits it on
    the card in the compute dtype, both directions; one it refuses raises
    naming fuse_gtu."""
    cfg = _fuse_gtu_config(toy_windowed, C, T)
    assert loop.resolve_fuse_gtu(cfg) is fits
    for backward in (False, True):
        assert gtu_fused.limit_error(C, T, dtype, backward) is None
    cfg = _fuse_gtu_config(toy_windowed, C + 8, T)
    with pytest.raises(ValueError, match=r"fuse_gtu.*16 \| C"):
        loop.resolve_fuse_gtu(cfg)


def test_trainer_refuses_fuse_gtu_over_the_card_budget(toy_windowed, tmp_path, monkeypatch):
    """The Trainer resolves fuse_gtu before any data is read: on a CUDA
    device the float32 C = 48, T = 144 that used to exceed a block's 227 KiB
    passes its gates now, and a shape JAX's gate refuses still raises at
    construction."""
    monkeypatch.setattr(loop, "resolve_device", lambda device: torch.device("cuda"))
    cfg = _fuse_gtu_config(toy_windowed, 48, 144)
    cfg.training.compute_dtype = "float32"
    assert loop.resolve_fuse_gtu(cfg) is True
    loop.check_fused_shapes(cfg, torch.device("cuda"), torch.float32)
    cfg = _fuse_gtu_config(toy_windowed, 40, 144)
    with pytest.raises(ValueError, match=r"fuse_gtu=true.*nb_time_filter=40"):
        loop.Trainer(cfg, experiments_root=str(tmp_path))


# (knob, dtype, N, widths, refused on the card): PEMS08 width (T = 12, H = 3,
# d_k = 32, d_model = 512, C = Co = 32) and GAMBIA width (T = 144, F = 4,
# K = H = 2, d_model = 64). The TAt passes stream N in column chunks and T
# in query tiles and key chunks, and the spatial passes stream N in tiles,
# so PEMS07's N = 883, GAMBIA's N = 2139, N = 3329 (past the bf16 TAt's
# old cap), LargeST California's N = 8600 and T = 576 and 1024 are
# admitted; so is a d_model of 4096, which the spatial embedding passes take
# in chunks of d (the kernels refuse only CUDA's grid and int32 limits).
PEMS08_WIDTH = dict(len_input=12, in_channels=1, nb_block=4, K=3, n_heads=3, d_k=32,
                    d_model=512, nb_chev_filter=32, nb_time_filter=32)
GAMBIA_WIDTH = dict(len_input=144, in_channels=4, nb_block=2, K=2, n_heads=2, d_k=32,
                    d_model=64, nb_chev_filter=32, nb_time_filter=32)
FUSED_CARD_CASES = [
    ("fuse_tat", "float32", 883, PEMS08_WIDTH, False),
    ("fuse_tat", "bfloat16", 883, PEMS08_WIDTH, False),
    ("fuse_tat", "float32", 170, PEMS08_WIDTH, False),
    ("fuse_tat", "bfloat16", 170, PEMS08_WIDTH, False),
    ("fuse_spatial", "float32", 170, PEMS08_WIDTH, False),
    ("fuse_spatial", "bfloat16", 170, PEMS08_WIDTH, False),
    ("fuse_spatial", "float32", 2139, GAMBIA_WIDTH, False),
    ("fuse_spatial", "bfloat16", 2139, GAMBIA_WIDTH, False),
    ("fuse_tat", "float32", 2139, GAMBIA_WIDTH, False),
    ("fuse_spatial", "float32", 883, PEMS08_WIDTH, False),
    ("fuse_spatial", "bfloat16", 883, PEMS08_WIDTH, False),
    ("fuse_spatial", "float32", 8192, PEMS08_WIDTH, False),
    ("fuse_spatial", "bfloat16", 8192, GAMBIA_WIDTH, False),
    ("fuse_tat", "bfloat16", 3329, PEMS08_WIDTH, False),
    ("fuse_spatial", "float32", 170, dict(PEMS08_WIDTH, d_model=4096), False),
    ("fuse_tat", "float32", 8600, PEMS08_WIDTH, False),
    ("fuse_tat", "bfloat16", 8600, PEMS08_WIDTH, False),
    ("fuse_tat", "float32", 170, dict(PEMS08_WIDTH, len_input=576), False),
    ("fuse_tat", "bfloat16", 170, dict(PEMS08_WIDTH, len_input=576), False),
    ("fuse_tat", "bfloat16", 170, dict(PEMS08_WIDTH, len_input=1024), False),
    ("fuse_tat", "float32", 170, dict(PEMS08_WIDTH, len_input=1024), False),
]


def _fused_config(toy_windowed, knob, dtype, N, widths):
    cfg = load_config(toy_windowed / "TOY.conf")
    setattr(cfg.training, knob, True)
    cfg.training.compute_dtype = dtype
    cfg.data.num_of_vertices = N
    for key, value in widths.items():
        setattr(cfg.data if key == "len_input" else cfg.training, key, value)
    cfg.training.d_v = cfg.training.d_k
    return cfg


@pytest.mark.parametrize("knob, dtype, N, widths, refused", FUSED_CARD_CASES)
def test_check_fused_shapes_checks_the_card_budget(toy_windowed, knob, dtype, N, widths,
                                                   refused):
    """On a CUDA device check_fused_shapes refuses, naming the knob, a block
    shape the fused kernels of the compute dtype cannot take, and admits
    every case here (the fused TAt's own gate, ``tat_fused.limit_error``,
    admits the block in both directions); on the CPU (the plain versions)
    every shape passes."""
    cfg = _fused_config(toy_windowed, knob, dtype, N, widths)
    dt = getattr(torch, dtype)
    loop.check_fused_shapes(cfg, torch.device("cpu"), dt)
    if refused:
        with pytest.raises(ValueError, match=rf"{knob}=true"):
            loop.check_fused_shapes(cfg, torch.device("cuda"), dt)
    else:
        loop.check_fused_shapes(cfg, torch.device("cuda"), dt)
    if knob == "fuse_tat":
        T = cfg.data.len_input
        for backward in (False, True):
            assert tat_fused.limit_error(T, N, widths["n_heads"], widths["d_k"],
                                         widths["d_k"], dt, backward) is None


# chip_smoke.py's two CLI paths of the fused TAt and GTU past their old caps:
# N = 8600 on BELL tiles with fuse_tat, and T = 576 with all three fused knobs
CLI_PATHS = {
    "large_n": (8600, PEMS08_WIDTH, dict(fuse_tat=True, sparse=True, sparse_format="bell",
                                         mask_format="tiles", block_size=128, rcm=True)),
    "long_t": (170, dict(PEMS08_WIDTH, len_input=576),
               dict(fuse_tat=True, fuse_spatial=True, fuse_gtu=True)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", sorted(CLI_PATHS))
def test_card_gates_accept_the_new_cli_paths(toy_windowed, path, dtype):
    """Both paths pass the Trainer's gates on a CUDA device name in both
    compute dtypes: check_fused_shapes refuses nothing and resolve_fuse_gtu
    turns the fused GTU on where it is set."""
    N, widths, knobs = CLI_PATHS[path]
    cfg = _fused_config(toy_windowed, "fuse_tat", dtype, N, widths)
    for key, value in knobs.items():
        setattr(cfg.training, key, value)
    loop.check_fused_shapes(cfg, torch.device("cuda"), getattr(torch, dtype))
    assert loop.resolve_fuse_gtu(cfg) is bool(knobs.get("fuse_gtu"))


def test_fuse_spatial_is_not_checked_on_the_bell_path(toy_windowed):
    """The fused spatial middle runs on the dense path only, so a BELL
    config with fuse_spatial at N = 2139 is not refused for it."""
    cfg = _fused_config(toy_windowed, "fuse_spatial", "bfloat16", 2139, GAMBIA_WIDTH)
    cfg.training.sparse, cfg.training.sparse_format = True, "bell"
    loop.check_fused_shapes(cfg, torch.device("cuda"), torch.bfloat16)


@pytest.mark.parametrize("knob, N, widths", [("fuse_tat", 883, PEMS08_WIDTH),
                                             ("fuse_spatial", 2139, GAMBIA_WIDTH)])
def test_trainer_refuses_fused_shapes_over_the_card_budget(toy_windowed, tmp_path,
                                                           monkeypatch, knob, N, widths):
    """The shapes the card refused in float32 (fuse_tat at PEMS07's N = 883,
    fuse_spatial at GAMBIA's N = 2139) now build a Trainer: its card check
    runs as on a CUDA device (check_fused_shapes with a cuda device, the
    call the Trainer makes there) and admits them, and the model is built
    at those widths, here on the CPU (the kernels have no CPU mode). A
    block past CUDA's grid or int32 limits, the one thing the fused
    kernels still refuse, raises at construction, before any data is read:
    fuse_spatial at a batch past the grid's 65,535, and fuse_tat (which the
    card check did not look at before) at a batch whose B·F·T rows pass
    int32."""
    real, seen = loop.check_fused_shapes, []
    monkeypatch.setattr(loop, "check_fused_shapes", lambda cfg, device, dtype: seen.append(
        real(cfg, torch.device("cuda"), dtype)))
    cfg = _fused_config(toy_windowed, knob, "float32", N, widths)
    rng = np.random.default_rng(0)
    T, n_pred = cfg.data.len_input, cfg.data.num_for_predict
    split = lambda: Split(rng.normal(size=(2, N, cfg.training.in_channels, T)).astype(
        np.float32), rng.normal(size=(2, N, n_pred)).astype(np.float32))
    data = ArrayDataset(split(), split(), split(), np.zeros(1, np.float32),
                        np.ones(1, np.float32))
    adj = (rng.random((N, N)) < 4.0 / N).astype(np.float32)
    tr = loop.Trainer(cfg, dataset=data, adj_merge=adj, adj_pa=adj,
                      experiments_root=str(tmp_path), device="cpu")
    assert seen == [None]
    assert getattr(tr.cfg.training, knob) and tr.spec.num_of_vertices == N
    assert tr.spec.d_model == widths["d_model"] and tr._splits["train"][0].shape[1] == N
    cfg = _fused_config(toy_windowed, "fuse_spatial", "float32", 170,
                        dict(PEMS08_WIDTH, d_model=4096))
    cfg.training.batch_size = 65536
    with pytest.raises(ValueError, match=r"fuse_spatial=true.*grid too large"):
        loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")
    cfg = _fused_config(toy_windowed, "fuse_tat", "float32", 170, PEMS08_WIDTH)
    cfg.training.batch_size = 2 ** 31 // 12 + 1
    with pytest.raises(ValueError, match=r"fuse_tat=true.*int32"):
        loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")


# (dtype, mask_format, use_pallas, refused on the card): the BELL forward
# kernel's one corner, K = H = 6 heads over in_channels = 64 (block 1),
# which the bf16 design cannot hold in a block and float32 takes; the
# plain BELL path (dense masks, no use_pallas) runs no kernel
# the block the bf16 forward refused before its channels came in chunks (H·C
# = 6·64), and a batch past CUDA's grid limit on B·H (refused on the paths
# that run the kernels)
BELL_CORNER = dict(in_channels=64, K=6, nb_chev_filter=4, nb_time_filter=4)
BELL_CARD_CASES = [("bfloat16", "tiles", False, True), ("bfloat16", "dense", True, True),
                   ("bfloat16", "dense", False, False), ("float32", "tiles", False, True)]


@pytest.mark.parametrize("dtype, mask_format, use_pallas, refused", BELL_CARD_CASES)
def test_check_fused_shapes_checks_the_bell_kernel(toy_windowed, dtype, mask_format,
                                                   use_pallas, refused):
    """On a CUDA device check_fused_shapes admits the H·C = 6·64 block the
    bf16 forward refused before, in both dtypes, and refuses, naming the
    BELL path and the limit, a batch whose B·H passes CUDA's grid limit, on
    the paths that run the kernels (``refused``); on the CPU every shape
    passes."""
    cfg = load_config(toy_windowed / "TOY.conf")
    t = cfg.training
    t.sparse, t.sparse_format, t.mask_format, t.use_pallas = True, "bell", mask_format, use_pallas
    t.compute_dtype = dtype
    for key, value in BELL_CORNER.items():
        setattr(t, key, value)
    dt = getattr(torch, dtype)
    loop.check_fused_shapes(cfg, torch.device("cpu"), dt)
    loop.check_fused_shapes(cfg, torch.device("cuda"), dt)
    t.batch_size = 20000
    loop.check_fused_shapes(cfg, torch.device("cpu"), dt)
    if refused:
        with pytest.raises(ValueError, match=r"sparse_format=bell.* block 1: .*grid too large "
                                             r"for B=20000, H=6"):
            loop.check_fused_shapes(cfg, torch.device("cuda"), dt)
    else:
        loop.check_fused_shapes(cfg, torch.device("cuda"), dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_fused_shapes_admits_the_bell_widths(toy_windowed, dtype):
    """The BELL kernel path at widths the card refused before: 128
    channels, d_k = 160 and block_size 160 pass the gate on a CUDA device."""
    cfg = load_config(toy_windowed / "TOY.conf")
    t = cfg.training
    t.sparse, t.sparse_format, t.mask_format, t.use_pallas = True, "bell", "tiles", True
    t.nb_chev_filter = t.nb_time_filter = 128
    t.d_k, t.block_size, t.compute_dtype = 160, 160, dtype
    loop.check_fused_shapes(cfg, torch.device("cuda"), getattr(torch, dtype))


def test_cli_refuses_flags_outside_the_slice(toy_windowed, tmp_path, monkeypatch):
    """The JAX CLI's multi-device flags are ported (ROADMAP §1 item 12): in
    one process without torchrun's environment, ``--distributed`` leaves
    the run a single process, and an axis flag asks for a mesh larger than
    the world, which raises JAX's ValueError before any data is read. Two
    ranks run in tests/test_torch_parallel_training.py."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    conf = str(toy_windowed / "TOY.conf")
    for flag, error in ((["--data-axis", "2", "--graph-axis", "1"],
                         r"data_axis\*graph_axis = 2 != 1 devices"),
                        (["--graph-axis", "2"], "graph_axis=2 must divide device count 1")):
        with pytest.raises(ValueError, match=error):
            train_cli.main(["--config", conf, "--device", "cpu", *flag])
    result = train_cli.main(["--config", conf, "--device", "cpu", "--distributed",
                             "--epochs", "1", "--experiments-root", str(tmp_path)])
    assert np.isfinite(result["test_loss"])
    assert not torch.distributed.is_initialized()
    assert not hasattr(train_cli, "_NOT_PORTED")


def test_trainer_needs_a_card_unless_told_cpu(toy_windowed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.Trainer(load_config(toy_windowed / "TOY.conf"))


def test_nan_loss_aborts(toy_windowed, tmp_path, monkeypatch):
    trainer = loop.Trainer(load_config(toy_windowed / "TOY.conf"),
                           experiments_root=str(tmp_path), device="cpu")
    monkeypatch.setattr(loop, "train_step", lambda *a, **k: torch.tensor(float("nan")))
    with pytest.raises(FloatingPointError, match="NaN training loss"):
        trainer.train_epoch(0)


# ---------------------------------------------------------------------------
# the block-sparse (BELL) trainer
# ---------------------------------------------------------------------------

BELL_KEYS = {"sparse": "true", "sparse_format": "bell", "block_size": "8"}


def _bell_conf(toy_windowed, tmp_path, name, **keys):
    """The toy config with extra [Training] keys (the section is last)."""
    text = (toy_windowed / "TOY.conf").read_text()
    extra = "".join(f"{k} = {v}\n" for k, v in {**BELL_KEYS, **keys}.items())
    path = tmp_path / f"{name}.conf"
    path.write_text(text + extra)
    return path


def test_cli_trains_bell_tiles_with_rcm(toy_windowed, tmp_path):
    conf = _bell_conf(toy_windowed, tmp_path, "TILES", mask_format="tiles", rcm="true",
                      use_pallas="true")
    exp = tmp_path / "exp"
    result = train_cli.main(["--config", str(conf), "--experiments-root", str(exp),
                             "--device", "cpu", "--epochs", "2"])
    run_dir = next((exp / "TOY").iterdir())
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_losses = [e["train_loss"] for e in events if e["event"] == "epoch"]
    assert len(train_losses) == 2 and train_losses[1] < train_losses[0]
    state = torch.load(run_dir / f"epoch_{result['best_epoch']}.pt", weights_only=False)
    assert any(k.endswith("cheb_conv_SAt.mask_tiles") for k in state["model"])
    with np.load(run_dir / f"output_epoch_{result['best_epoch']}_test.npz") as d:
        trainer = loop.Trainer(load_config(conf), experiments_root=str(tmp_path / "x"),
                               device="cpu")
        np.testing.assert_array_equal(d["data_target_tensor"], trainer.dataset.test.target)
        assert d["prediction"].shape == d["data_target_tensor"].shape
        assert np.isfinite(d["prediction"]).all()
    assert not np.array_equal(trainer._perm, np.arange(len(trainer._perm)))


def test_rcm_predictions_come_back_in_original_order(toy_windowed, tmp_path):
    """The RCM-permuted BELL trainer (dense masks, fused kernel path) with
    permuted weights predicts what the unpermuted one does, node for node."""
    plain = loop.Trainer(load_config(_bell_conf(toy_windowed, tmp_path, "P", use_pallas="true")),
                         experiments_root=str(tmp_path / "p"), device="cpu")
    rcm = loop.Trainer(load_config(_bell_conf(toy_windowed, tmp_path, "R", use_pallas="true",
                                              rcm="true")),
                       experiments_root=str(tmp_path / "r"), device="cpu")
    perm = rcm._perm
    assert plain._perm is None and not np.array_equal(perm, np.arange(len(perm)))
    rcm.model.load_state_dict(permute_nodes(plain.model.state_dict(), perm))
    rcm.constants["cheb_polys"] = plain.constants["cheb_polys"][:, perm][:, :, perm]
    pred_plain, loss_plain = plain.evaluate("test")
    pred_rcm, loss_rcm = rcm.evaluate("test")
    np.testing.assert_allclose(pred_rcm, pred_plain, atol=2e-4, rtol=2e-4)
    assert loss_rcm == pytest.approx(loss_plain, rel=1e-4)


@pytest.mark.parametrize("widths", [dict(nb_chev_filter=8, nb_time_filter=8, d_k=8),
                                    dict(nb_chev_filter=128, nb_time_filter=128, d_k=160)],
                         ids=["narrow", "c128_dk160"])
def test_three_step_bell_tiles_trajectory_matches_jax(widths):
    """Tile-resident BELL, same weights and batches, dropout 0: per-step
    SmoothL1 + Adam losses agree with the JAX trainer step (its kernels in
    interpret mode) to rtol 2e-3 / atol 2e-4; also at 128 channels and d_k =
    160, widths the card's BELL kernels refused before."""
    from dstagnn_drought_tpu.ops.block_sparse import block_ell_from_adjacency as jax_bell
    from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency

    rng = np.random.default_rng(11)
    N, T, P, lr, bs = 12, 12, 4, 1e-3, 4
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=P, num_of_d=1,
              nb_block=2, in_channels=1, K=2, d_model=16, n_heads=2, dropout_rate=0.0,
              **widths)
    A = (rng.random((N, N)) < 0.25).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = ((rng.random((N, N)) < 0.6) & (A > 0)).astype(np.float32)
    x = rng.normal(size=(12, N, 1, T)).astype(np.float32)
    y = rng.normal(size=(12, N, P)).astype(np.float32)
    jspec, spec = JaxSpec(**kw), ModelSpec(**kw)
    jbell, bell = jax_bell(A, block_size=8), block_ell_from_adjacency(A, block_size=8)
    params, consts = jax_make_model(jax.random.PRNGKey(3), jspec, A, pa, bell=jbell)
    model = DSTAGNN(spec, bell=bell)
    model.load_state_dict(params_from_jax(params, spec))
    c = {**constants_from_jax(consts), "bell": bell}
    consts = {**consts, "ell": jbell}

    idx = np.random.default_rng(0).permutation(12)[:3 * bs].reshape(3, bs)
    step = make_train_step(jspec, jax_optimizer(lr))
    p, s, key = params, jax_optimizer(lr).init(params), jax.random.PRNGKey(0)
    jax_losses = []
    for b in range(3):
        p, s, key, loss = step(p, s, key, x, y, idx[b], consts)
        jax_losses.append(float(loss))

    optimizer = make_optimizer(model.parameters(), lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(train_step(model, optimizer, xt[i], yt[i], c))
              for i in torch.from_numpy(idx.astype(np.int64))]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
    assert abs(losses[0] - losses[-1]) > 1e-4


def test_check_slice_still_refuses_ell_and_graph_axis(toy_windowed, tmp_path):
    """sparse_format='ell' is ported: the Trainer builds its EllGraph and
    trains; graph_axis > 1 is ported too (multi-device), and in one process
    the Trainer's mesh raises JAX's ValueError: the world has one rank."""
    cfg = load_config(_bell_conf(toy_windowed, tmp_path, "E", sparse_format="ell"))
    trainer = loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")
    assert "ell" in trainer.constants and "bell" not in trainer.constants
    assert trainer.mesh is None
    assert np.isfinite(trainer.train_epoch(0))
    cfg = load_config(_bell_conf(toy_windowed, tmp_path, "G", graph_axis="2"))
    with pytest.raises(ValueError, match=r"data_axis\*graph_axis = 2 != 1 devices"):
        loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")


@pytest.mark.parametrize("axis", ["data_axis", "graph_axis"])
def test_check_slice_refuses_multi_device(toy_windowed, tmp_path, axis):
    """An axis of 2 on the ELL path is taken (no NotImplementedError): the
    Trainer builds its mesh, which in one process raises JAX's ValueError;
    a batch that does not divide over the data axis is refused before."""
    cfg = load_config(_bell_conf(toy_windowed, tmp_path, axis, sparse_format="ell",
                                 halo="targeted", **{axis: "2"}))
    with pytest.raises(ValueError, match=r"data_axis\*graph_axis = 2 != 1 devices"):
        loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")
    cfg.training.batch_size = 3
    if axis == "data_axis":
        with pytest.raises(ValueError, match="batch_size=3 must divide over data_axis=2"):
            loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# the edge-list (ELL) trainer
# ---------------------------------------------------------------------------

def test_cli_trains_sparse_on_the_default_ell_format(toy_windowed, tmp_path):
    text = (toy_windowed / "TOY.conf").read_text()
    conf = tmp_path / "SPARSE.conf"
    conf.write_text(text + "sparse = true\n")
    assert load_config(conf).training.sparse_format == "ell"
    exp = tmp_path / "exp"
    result = train_cli.main(["--config", str(conf), "--experiments-root", str(exp),
                             "--device", "cpu", "--epochs", "2"])
    run_dir = next((exp / "TOY").iterdir())
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_losses = [e["train_loss"] for e in events if e["event"] == "epoch"]
    assert len(train_losses) == 2 and train_losses[1] < train_losses[0]
    assert (run_dir / f"epoch_{result['best_epoch']}.pt").exists()
    with np.load(run_dir / f"output_epoch_{result['best_epoch']}_test.npz") as d:
        assert d["prediction"].shape == d["data_target_tensor"].shape
        assert np.isfinite(d["prediction"]).all()


def test_rcm_leaves_the_ell_node_order_alone(toy_windowed, tmp_path):
    """rcm applies to BELL only, as in JAX: on ELL the trainer keeps the
    original order; max_degree caps the EllGraph's slots."""
    from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency

    cfg = load_config(_bell_conf(toy_windowed, tmp_path, "R", sparse_format="ell",
                                 rcm="true", max_degree="2"))
    trainer = loop.Trainer(cfg, experiments_root=str(tmp_path), device="cpu")
    assert trainer._perm is None and trainer._inv_perm is None
    adj_merge, _ = loop.load_graphs(cfg)
    want = ell_from_adjacency(adj_merge, max_degree=2)
    np.testing.assert_array_equal(trainer.constants["ell"].indices, want.indices)
    np.testing.assert_array_equal(trainer.constants["ell"].mask, want.mask)
    np.testing.assert_array_equal(trainer._splits["test"][0].numpy(),
                                  trainer.dataset.test.x)


def test_three_step_ell_trajectory_matches_jax():
    """ELL, same weights and batches, dropout 0: per-step SmoothL1 + Adam
    losses agree with the JAX trainer step to rtol 2e-3 / atol 2e-4."""
    from dstagnn_drought_tpu.ops.sparse import ell_from_adjacency as jax_ell
    from dstagnn_drought_tpu_torch.ops.sparse import ell_from_adjacency

    rng = np.random.default_rng(12)
    N, T, P, lr, bs = 12, 12, 4, 1e-3, 4
    kw = dict(num_of_vertices=N, len_input=T, num_for_predict=P, num_of_d=1,
              nb_block=2, in_channels=1, K=2, nb_chev_filter=8, nb_time_filter=8,
              d_model=16, d_k=8, n_heads=2, dropout_rate=0.0)
    A = (rng.random((N, N)) < 0.25).astype(np.float32)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    pa = (rng.random((N, N)) < 0.4).astype(np.float32)
    x = rng.normal(size=(12, N, 1, T)).astype(np.float32)
    y = rng.normal(size=(12, N, P)).astype(np.float32)
    jspec, spec = JaxSpec(**kw), ModelSpec(**kw)
    params, consts = jax_make_model(jax.random.PRNGKey(4), jspec, A, pa)
    model = DSTAGNN(spec)
    model.load_state_dict(params_from_jax(params, spec))
    c = {**constants_from_jax(consts), "ell": ell_from_adjacency(A)}
    consts = {**consts, "ell": jax_ell(A)}

    idx = np.random.default_rng(1).permutation(12)[:3 * bs].reshape(3, bs)
    step = make_train_step(jspec, jax_optimizer(lr))
    p, s, key = params, jax_optimizer(lr).init(params), jax.random.PRNGKey(0)
    jax_losses = []
    for b in range(3):
        p, s, key, loss = step(p, s, key, x, y, idx[b], consts)
        jax_losses.append(float(loss))

    optimizer = make_optimizer(model.parameters(), lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(train_step(model, optimizer, xt[i], yt[i], c))
              for i in torch.from_numpy(idx.astype(np.int64))]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-4)
    assert abs(losses[0] - losses[-1]) > 1e-4


# ---------------------------------------------------------------------------
# the model zoo through the Trainer and the CLI
# ---------------------------------------------------------------------------

ZOO = ["astgcn", "mstgcn", "stgcn", "transformer"]


def _zoo_conf(toy_windowed, tmp_path, name, extra=""):
    """The toy config with ``model_name = name`` and extra [Training] keys."""
    text = (toy_windowed / "TOY.conf").read_text()
    assert "model_name = dstagnn\n" in text
    path = tmp_path / f"{name}.conf"
    path.write_text(text.replace("model_name = dstagnn\n", f"model_name = {name}\n") + extra)
    return path


@pytest.mark.parametrize("name", ZOO)
def test_cli_trains_a_zoo_family_and_resumes(toy_windowed, tmp_path, name):
    """``cli.train --device cpu`` trains the family (``--use-pallas`` is
    accepted and changes nothing: the family has no kernel), checkpoints
    its state_dict, writes the test dump and the report, and resumes."""
    from dstagnn_drought_tpu_torch.training.step import eval_step

    conf = str(_zoo_conf(toy_windowed, tmp_path, name))
    exp = tmp_path / "exp"
    args = ["--config", conf, "--experiments-root", str(exp), "--device", "cpu"]
    result = train_cli.main(args + ["--epochs", "2", "--use-pallas"])
    run_dir = next((exp / "TOY").iterdir())
    assert run_dir.name.startswith(f"{name}_")
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_losses = [e["train_loss"] for e in events if e["event"] == "epoch"]
    assert len(train_losses) == 2 and np.isfinite(train_losses).all()
    assert train_losses[1] < train_losses[0]
    with np.load(run_dir / f"output_epoch_{result['best_epoch']}_test.npz") as d:
        assert d["prediction"].shape == d["data_target_tensor"].shape
        assert np.isfinite(d["prediction"]).all()
    assert len(result["report"]["per_horizon"]) == 12

    trainer = loop.Trainer(load_config(conf), experiments_root=str(exp), device="cpu")
    assert trainer.family.__name__.endswith(f".{name}")
    assert trainer.resume()
    assert (trainer.epoch, trainer.best_epoch) == (2, result["best_epoch"])
    assert trainer.best_val == pytest.approx(result["best_val"])
    x, y = (s[:4] for s in trainer._splits["test"])
    preds = [eval_step(trainer.model, x, y, trainer.constants, use_pallas=use)[0]
             for use in (True, False)]
    torch.testing.assert_close(preds[0], preds[1], rtol=0, atol=0)
    train_cli.main(args + ["--epochs", "3", "--resume"])
    events = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [0, 1, 2]


def _refuse_data(monkeypatch):
    """Make reading the windowed npz or the graphs fail loudly."""
    def boom(*a, **k):
        raise AssertionError("data or graphs read before the config was refused")
    monkeypatch.setattr(loop, "load_windowed_dataset", boom)
    monkeypatch.setattr(loop, "load_graphs", boom)


@pytest.mark.parametrize("knob", ["sparse", "fuse_tat", "fuse_spatial"])
def test_trainer_refuses_dstagnn_paths_on_a_zoo_family(toy_windowed, tmp_path, monkeypatch,
                                                       knob):
    """JAX's ValueError, word for word, before any data or graph is read."""
    from dstagnn_drought_tpu.config import load_config as jax_load_config
    from dstagnn_drought_tpu.training.loop import Trainer as JaxTrainer

    conf = _zoo_conf(toy_windowed, tmp_path, "astgcn", f"{knob} = true\n")
    with pytest.raises(ValueError) as theirs:
        JaxTrainer(jax_load_config(conf), experiments_root=str(tmp_path / "jax"))
    _refuse_data(monkeypatch)
    with pytest.raises(ValueError) as ours:
        loop.Trainer(load_config(conf), experiments_root=str(tmp_path), device="cpu")
    assert str(ours.value) == str(theirs.value)
    assert "dstagnn-family" in str(ours.value)


def test_trainer_refuses_an_unknown_model_name(toy_windowed, tmp_path, monkeypatch):
    from dstagnn_drought_tpu.models import get_family as jax_family

    conf = _zoo_conf(toy_windowed, tmp_path, "transformer9000")
    with pytest.raises(ValueError) as theirs:
        jax_family("transformer9000")
    _refuse_data(monkeypatch)
    with pytest.raises(ValueError) as ours:
        loop.Trainer(load_config(conf), experiments_root=str(tmp_path), device="cpu")
    assert str(ours.value) == str(theirs.value)
