"""The port's INI loader against the JAX package's: ``dataclasses.asdict`` of
both ``load_config``s agrees on inline INI strings, and both refuse the same
invalid files."""
import dataclasses

import pytest

from dstagnn_drought_tpu import config as jax_config
from dstagnn_drought_tpu_torch import config as port_config
from dstagnn_drought_tpu_torch.parallel.mesh import make_mesh
from dstagnn_drought_tpu_torch.training.loop import check_family, check_parallel

PEMS08 = """[Data]
adj_filename = ./data/PEMS08/PEMS08.csv
graph_signal_matrix_filename = ./data/PEMS08/PEMS08.npz
stag_filename = ./data/PEMS08/stag_001_PEMS08.csv
strg_filename = ./data/PEMS08/strg_001_PEMS08.csv
num_of_vertices = 170
points_per_hour = 12
num_for_predict = 12
len_input = 12
dataset_name = PEMS08

[Training]
use_tpu = True
ctx = 0
in_channels = 1
nb_block = 4
n_heads = 3
K = 3
d_k = 32
d_model = 512
nb_chev_filter = 32
nb_time_filter = 32
batch_size = 32
model_name = dstagnn
num_of_weeks = 0
num_of_days = 0
num_of_hours = 1
start_epoch = 0
epochs = 100
learning_rate = 0.0001
"""

GAMBIA = """[Data]
adj_filename = a.csv
graph_signal_matrix_filename = g.npz
num_of_vertices = 2139
points_per_hour = 12
len_input = 144
dataset_name = GAMBIA

[Training]
in_channels = 4
nb_block = 2
n_heads = 2
K = 2
d_model = 64
graph = AG
compute_dtype = bfloat16
use_pallas = true
fuse_gtu = auto
dropout = 0.1
d_v = 16
"""

KNOBS = """[Data]
num_of_vertices = 20
[Training]
sparse = yes
sparse_format = bell
mask_format = tiles
fuse_gtu = false
nan_policy = rollback
halo = targeted
"""


@pytest.mark.parametrize("text", [PEMS08, GAMBIA, KNOBS], ids=["pems08", "gambia", "knobs"])
def test_load_config_matches_jax(tmp_path, text):
    path = tmp_path / "c.conf"
    path.write_text(text)
    ours = port_config.load_config(path)
    theirs = jax_config.load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    # the reference PEMS confs lack ``graph``: it defaults to 'G'
    assert ours.training.graph == theirs.training.graph
    assert ours.num_of_d == theirs.num_of_d

    out = tmp_path / "saved.conf"
    port_config.save_config(ours, out)
    assert dataclasses.asdict(port_config.load_config(out)) == dataclasses.asdict(ours)


def test_case_insensitive_keys(tmp_path):
    path = tmp_path / "c.conf"
    path.write_text("[Data]\nnum_of_vertices = 5\n[Training]\nk = 2\nD_MODEL = 8\n")
    cfg = port_config.load_config(path)
    assert (cfg.training.K, cfg.training.d_model) == (2, 8)


@pytest.mark.parametrize("bad", [
    "[Data]\nnum_of_vertices = 0\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\nK = 0\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\ngraph = X\n",
    "[Data]\nnum_of_vertices = 5\nlen_input = 6\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\ncompute_dtype = float16\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\nsparse_format = coo\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\nmask_format = tiles\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\nnan_policy = retry\n",
    "[Data]\nnum_of_vertices = 5\n[Training]\nfuse_gtu = sometimes\n",
])
def test_validation_errors_match_jax(tmp_path, bad):
    path = tmp_path / "bad.conf"
    path.write_text(bad)
    with pytest.raises(ValueError) as ours:
        port_config.load_config(path)
    with pytest.raises(ValueError) as theirs:
        jax_config.load_config(path)
    assert str(ours.value) == str(theirs.value)


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        port_config.load_config("/nonexistent/x.conf")


def _cfg(**training):
    return port_config.Config(port_config.DataConfig(num_of_vertices=5),
                              port_config.TrainingConfig(**training))


@pytest.mark.parametrize("knob,value", [
    ("tp", True), ("data_axis", 2), ("graph_axis", 2),
])
def test_options_outside_the_slice_are_refused(knob, value):
    """The multi-device options are ported (ROADMAP §1 item 12):
    check_parallel takes each; what is refused now is JAX's: a mesh larger
    than the world (one process here) raises make_mesh's ValueError, and a
    batch that does not divide over the data axis raises."""
    cfg = _cfg(**{knob: value})
    check_parallel(cfg)  # the default batch of 32 divides over 2
    t = cfg.training
    if t.data_axis * t.graph_axis > 1:
        with pytest.raises(ValueError, match=r"data_axis\*graph_axis = 2 != 1 devices"):
            make_mesh(t.data_axis, t.graph_axis)
    else:
        assert make_mesh(t.data_axis, t.graph_axis).shape == {"data": 1, "graph": 1}
    t.batch_size, t.data_axis = 3, 2
    with pytest.raises(ValueError, match="batch_size=3 must divide over data_axis=2"):
        check_parallel(cfg)


@pytest.mark.parametrize("knob,value", [
    ("debug", True), ("nan_policy", "rollback"), ("tensorboard", True), ("remat", True),
])
def test_single_card_knobs_are_in_the_slice(knob, value):
    """debug, NaN rollback, TensorBoard and remat pass check_parallel alone
    and with the multi-device options on, as JAX's trainer takes them on a
    mesh; an axis below 1 is refused with them."""
    cfg = _cfg(**{knob: value})
    check_parallel(cfg)
    cfg.training.tp, cfg.training.data_axis, cfg.training.graph_axis = True, 2, 2
    check_parallel(cfg)
    cfg.training.graph_axis = 0
    with pytest.raises(ValueError, match="must be >= 1"):
        check_parallel(cfg)


@pytest.mark.parametrize("name", ["astgcn", "mstgcn", "stgcn", "transformer"])
def test_zoo_families_are_in_the_slice(name):
    """The model zoo is ported: every family's model_name resolves to its
    module and passes check_parallel, on one card and on a mesh."""
    cfg = _cfg(model_name=name)
    assert check_family(cfg).__name__.endswith(f".{name}")
    check_parallel(cfg)
    cfg.training.data_axis = 2
    check_parallel(cfg)


def test_bell_options_are_in_the_slice():
    """Both sparse formats with every mask format, rcm and max_degree pass
    check_parallel, alone and with a graph axis (the partitioned BELL and
    ELL paths)."""
    cfg = _cfg()
    for graph_axis in (1, 2):
        t = cfg.training
        t.graph_axis = graph_axis
        for fmt in ("dense", "tiles"):
            for rcm in (False, True):
                t.sparse, t.sparse_format, t.mask_format, t.rcm = True, "bell", fmt, rcm
                check_parallel(cfg)
        t.sparse_format, t.mask_format, t.max_degree, t.halo = "ell", "dense", 3, "targeted"
        for rcm in (False, True):
            t.rcm = rcm
            check_parallel(cfg)
    assert port_config.TrainingConfig().sparse_format == "ell"


@pytest.mark.parametrize("knobs", [("fuse_tat",), ("fuse_spatial",),
                                   ("fuse_tat", "fuse_spatial"), ("fuse_gtu",),
                                   ("fuse_tat", "fuse_gtu"),
                                   ("fuse_tat", "fuse_spatial", "fuse_gtu")])
def test_fused_options_are_in_the_slice(knobs):
    """Every fused kernel pair (temporal attention, spatial middle, GTU
    tail), alone and together, and with remat, passes check_parallel; so
    does tp with them (under tp the fused TAt takes the slices gathered
    whole, as GSPMD gives a pallas_call whole operands)."""
    cfg = _cfg()
    for knob in knobs:
        setattr(cfg.training, knob, True)
    check_parallel(cfg)
    cfg.training.remat = True
    check_parallel(cfg)
    cfg.training.tp, cfg.training.graph_axis = True, 2
    check_parallel(cfg)
