"""Evaluation CLI of the port — counterpart of
``dstagnn_drought_tpu/cli/evaluate.py``: load one of the port's
checkpoints, predict a split, write the predictions npz and print the
per-horizon MAE/RMSE/MAPE table; with ``--export-attention`` also the
per-block spatial maps of one sample.

Usage:
    python -m dstagnn_drought_tpu_torch.cli.evaluate --config C [--split test] \
        [--checkpoint RUN_DIR/epoch_N.pt] [--experiments-root DIR] \
        [--export-attention] [--attention-sample 24] [--use-pallas] [--device cpu]

Writes ``output_epoch_<e>_<split>.npz`` into the run dir and, with
``--export-attention``, ``attention_<split>.npz`` (``block_<i>`` per
block), ``attention_<split>.csv`` (block 0, head 0) and
``attention_<split>.png`` (a heatmap; skipped with a message where
matplotlib is missing, the npz and CSV still written). Runs on ``cuda``
unless ``--device cpu`` is given; ``--use-pallas`` takes the predictions'
Chebyshev aggregation through the CUDA kernel (the maps come from JAX's
export forward, which leaves it off; on the dense path they are the scores
computed before the aggregation either way).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dstagnn_drought_tpu_torch.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a trained model (PyTorch/CUDA port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--split", choices=("train", "val", "test"), default="test")
    parser.add_argument("--checkpoint", default=None,
                        help="explicit checkpoint; default: latest in run dir")
    parser.add_argument("--experiments-root", default="myexperiments")
    parser.add_argument("--export-attention", action="store_true",
                        help="dump per-block spatial attention for one sample "
                             "(npz + CSV + heatmap PNG)")
    parser.add_argument("--attention-sample", type=int, default=24,
                        help="sample index for --export-attention")
    parser.add_argument("--use-pallas", action="store_true",
                        help="the CUDA kernel on the Chebyshev-attention path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.use_pallas:
        cfg.training.use_pallas = True

    from dstagnn_drought_tpu_torch.training import checkpoint as ckpt
    from dstagnn_drought_tpu_torch.training.loop import Trainer
    from dstagnn_drought_tpu_torch.training.metrics import horizon_report

    trainer = Trainer(cfg, experiments_root=args.experiments_root, device=args.device)
    path = args.checkpoint or ckpt.latest_checkpoint(trainer.run_dir)
    if path is None:
        raise SystemExit(f"no checkpoint found under {trainer.run_dir}")
    state = ckpt.restore_checkpoint(path, map_location=trainer.device)
    trainer.model.load_state_dict(state["model"])
    meta = state["meta"]
    print(f"loaded {path} (epoch {meta.get('epoch', '?')})")

    pred, loss = trainer.evaluate(args.split)
    target = getattr(trainer.dataset, args.split).target
    report = horizon_report(target, pred, null_val=0)

    out = os.path.join(trainer.run_dir, f"output_epoch_{meta.get('epoch', 0)}_{args.split}.npz")
    np.savez(out, prediction=pred, data_target_tensor=target)
    print(f"loss: {loss:.4f}; predictions saved to {out}")
    print(f"{'horizon':>7} {'MAE':>8} {'RMSE':>8} {'MAPE%':>8}")
    for row in report["per_horizon"]:
        print(f"{row['horizon']:>7} {row['mae']:>8.2f} {row['rmse']:>8.2f} "
              f"{row['mape']:>8.2f}")
    o = report["overall"]
    print(f"{'all':>7} {o['mae']:>8.2f} {o['rmse']:>8.2f} {o['mape']:>8.2f}")

    if args.export_attention:
        maps = trainer.attention_maps(args.split, args.attention_sample)
        att_npz = os.path.join(trainer.run_dir, f"attention_{args.split}.npz")
        np.savez(att_npz, **{f"block_{i}": m for i, m in enumerate(maps)})
        # head 0 of block 0 as CSV, the tabular format without an Excel writer
        head0 = maps[0][0]
        csv_path = os.path.join(trainer.run_dir, f"attention_{args.split}.csv")
        np.savetxt(csv_path, head0, delimiter=",")
        png_path = os.path.join(trainer.run_dir, f"attention_{args.split}.png")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(6, 5))
            im = ax.imshow(head0, cmap="viridis", aspect="auto")
            ax.set_xlabel("target node")
            ax.set_ylabel("source node")
            fig.colorbar(im, ax=ax)
            fig.savefig(png_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
        except ImportError as exc:  # matplotlib optional: CSV and npz still written
            print(f"heatmap skipped: {exc}")
            png_path = None
        print(f"attention maps: {att_npz} {csv_path}" + (f" {png_path}" if png_path else ""))
    return report


if __name__ == "__main__":
    main()
