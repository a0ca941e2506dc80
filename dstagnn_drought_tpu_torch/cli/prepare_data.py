"""Dataset preparation CLI of the port — counterpart of
``dstagnn_drought_tpu/cli/prepare_data.py`` (the reference's
``prepareData.py``).

Usage:
    python -m dstagnn_drought_tpu_torch.cli.prepare_data --config <conf>

Reads the raw ``graph_signal_matrix_filename`` npz and writes the windowed
``<name>_r{h}_d{d}_w{w}_dstagnn.npz`` next to it (reference format). numpy
only; no device.
"""
from __future__ import annotations

import argparse

from dstagnn_drought_tpu_torch.config import load_config
from dstagnn_drought_tpu_torch.data.windowing import (
    read_and_generate_dataset,
    windowed_npz_path,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Prepare windowed dataset")
    parser.add_argument("--config", default="configurations/GAMBIA_dstagnn.conf")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    t, d = cfg.training, cfg.data
    all_data = read_and_generate_dataset(
        d.graph_signal_matrix_filename,
        t.num_of_weeks, t.num_of_days, t.num_of_hours,
        d.num_for_predict, points_per_hour=d.points_per_hour, save=True,
    )
    out = windowed_npz_path(
        d.graph_signal_matrix_filename, t.num_of_hours, t.num_of_days, t.num_of_weeks
    )
    for split in ("train", "val", "test"):
        print(f"{split}: x{all_data[split]['x'].shape} "
              f"target{all_data[split]['target'].shape}")
    print(f"saved: {out}.npz")


if __name__ == "__main__":
    main()
