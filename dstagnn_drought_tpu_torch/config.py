"""Typed configuration with a loader for the reference INI format.

Counterpart of ``dstagnn_drought_tpu/config.py``: the same dataclasses, the
same INI coercion and the same validation, so ``dataclasses.asdict`` of both
loaders agrees on any file. Documented deviations from the reference INI
handling (kept identical to the JAX package):
  * ``graph`` defaults to ``'G'`` when absent (the reference crashes with a
    KeyError on PEMS03/07/08 confs, which lack the key);
  * option names match fields case-insensitively (``K = 2`` sets ``K``);
  * ``d_v`` defaults to ``d_k``; unknown keys are ignored.

Knobs that belong to paths this package does not run yet are parsed and
validated here and refused by the trainer (``training/loop.py``).
"""
from __future__ import annotations

import configparser
import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class DataConfig:
    adj_filename: str = ""
    graph_signal_matrix_filename: str = ""
    stag_filename: str = ""
    strg_filename: str = ""
    id_filename: Optional[str] = None
    num_of_vertices: int = 0
    points_per_hour: int = 1
    num_for_predict: int = 12
    len_input: int = 12
    dataset_name: str = ""
    period: int = 12  # parsed for compat; unused by the reference too


@dataclasses.dataclass
class TrainingConfig:
    model_name: str = "dstagnn"
    in_channels: int = 1
    nb_block: int = 4
    n_heads: int = 3
    K: int = 3
    d_k: int = 32
    d_v: int = -1  # -1 → defaults to d_k (reference behaviour)
    d_model: int = 512
    nb_chev_filter: int = 32
    nb_time_filter: int = 32
    time_strides: int = 1
    batch_size: int = 32
    graph: str = "G"  # 'G' = raw adjacency, 'AG' = STAG aware-graph
    num_of_weeks: int = 0
    num_of_days: int = 0
    num_of_hours: int = 1
    start_epoch: int = 0
    epochs: int = 100
    learning_rate: float = 1e-4
    dropout: float = 0.05
    seed: int = 1
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    use_pallas: bool = False        # hand-written kernel on the cheb-attention path
    sparse: bool = False
    sparse_format: str = "ell"      # "ell" | "bell"
    block_size: int = 128
    mask_format: str = "dense"      # "dense" | "tiles" (needs sparse bell)
    max_degree: int = 0
    data_axis: int = 1
    graph_axis: int = 1
    halo: str = "gather"
    halo_overlap: bool = True
    remat: bool = False
    fuse_tat: bool = False
    fuse_spatial: bool = False
    fuse_gtu: str | bool = "auto"   # "auto" resolves off
    checkpoint_every: int = 0       # 0 = only best-val checkpoints
    tensorboard: bool = False
    nan_policy: str = "abort"       # "abort" | "rollback"
    max_rollbacks: int = 2
    rcm: bool = False
    tp: bool = False
    debug: bool = False
    prng_impl: str = "rbg"          # JAX bit-generator name; the port's
                                    # dropout always uses torch.Generator

    def __post_init__(self):
        if self.d_v < 0:
            self.d_v = self.d_k


@dataclasses.dataclass
class Config:
    data: DataConfig
    training: TrainingConfig

    @property
    def num_of_d(self) -> int:
        # the reference passes in_channels for both num_of_d and in_channels
        return self.training.in_channels

    def validate(self) -> "Config":
        t, d = self.training, self.data
        if d.num_of_vertices <= 0:
            raise ValueError("num_of_vertices must be positive")
        if t.K < 1:
            raise ValueError("K (Chebyshev order) must be >= 1")
        if t.graph not in ("G", "AG"):
            raise ValueError(f"graph must be 'G' or 'AG', got {t.graph!r}")
        if d.len_input < 7:
            # GTU7 is a width-7 valid conv over time; shorter inputs make
            # 3T-12 <= 0
            raise ValueError("len_input must be >= 7 for the GTU(3/5/7) stack")
        if t.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {t.compute_dtype!r}")
        if t.sparse_format not in ("ell", "bell"):
            raise ValueError(f"sparse_format must be 'ell' or 'bell', got "
                             f"{t.sparse_format!r}")
        if t.mask_format not in ("dense", "tiles"):
            raise ValueError(f"mask_format must be 'dense' or 'tiles', got "
                             f"{t.mask_format!r}")
        if t.mask_format == "tiles" and not (
            t.sparse and t.sparse_format == "bell"
        ):
            raise ValueError(
                "mask_format='tiles' stores masks on the BELL tile support; "
                "set sparse=true and sparse_format='bell'"
            )
        if t.nan_policy not in ("abort", "rollback"):
            raise ValueError(f"nan_policy must be 'abort' or 'rollback', got "
                             f"{t.nan_policy!r}")
        if not isinstance(t.fuse_gtu, bool) and t.fuse_gtu != "auto":
            raise ValueError(f"fuse_gtu must be a bool or 'auto', got "
                             f"{t.fuse_gtu!r}")
        return self


_BOOL = {"true": True, "false": False, "1": True, "0": False, "yes": True, "no": False}


def _coerce(field: dataclasses.Field, raw: str):
    ftype = field.type
    if ftype in ("int", int):
        return int(raw)
    if ftype in ("float", float):
        return float(raw)
    if ftype in ("bool", bool):
        return _BOOL[raw.strip().lower()]
    if ftype in ("str | bool",):
        low = raw.strip().lower()
        return _BOOL[low] if low in _BOOL else low
    if ftype in ("Optional[str]",):
        return raw or None
    return raw


def load_config(path: str | Path) -> Config:
    """Load a reference-format INI file into a typed :class:`Config`."""
    parser = configparser.ConfigParser()
    read = parser.read(str(path))
    if not read:
        raise FileNotFoundError(f"config file not found: {path}")

    def fill(cls, section):
        kwargs = {}
        # configparser lowercases option names, so match fields
        # case-insensitively
        fields = {f.name.lower(): f for f in dataclasses.fields(cls)}
        for key, raw in section.items():
            f = fields.get(key.lower())
            if f is not None:
                kwargs[f.name] = _coerce(f, raw)
        return cls(**kwargs)

    data = fill(DataConfig, parser["Data"]) if parser.has_section("Data") else DataConfig()
    training = (
        fill(TrainingConfig, parser["Training"])
        if parser.has_section("Training")
        else TrainingConfig()
    )
    return Config(data=data, training=training).validate()


def save_config(cfg: Config, path: str | Path) -> None:
    """Write a Config back to the reference INI format."""
    parser = configparser.ConfigParser()
    parser["Data"] = {
        k: str(v) for k, v in dataclasses.asdict(cfg.data).items() if v is not None
    }
    parser["Training"] = {k: str(v) for k, v in dataclasses.asdict(cfg.training).items()}
    with open(path, "w") as f:
        parser.write(f)
