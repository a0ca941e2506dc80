"""Training CLI of the port — counterpart of ``dstagnn_drought_tpu/cli/train.py``.

Usage:
    python -m dstagnn_drought_tpu_torch.cli.train --config PEMS08.conf \
        [--epochs N] [--resume] [--experiments-root DIR] [--bfloat16] \
        [--use-pallas] [--tensorboard] [--profile LOGDIR] [--device cpu]

Trains the config's ``model_name`` (``dstagnn``, ``astgcn``, ``mstgcn``,
``stgcn`` or ``transformer``). Runs on ``cuda`` unless ``--device cpu`` is
given. ``--use-pallas`` keeps the JAX CLI's name and switches DSTAGNN's
Chebyshev aggregation to the CUDA kernel; on the other families, which have
no kernel, it is accepted and changes nothing, as in JAX.
``--tensorboard`` writes TensorBoard scalars to ``<run_dir>/tb`` beside
metrics.jsonl; ``--profile LOGDIR`` traces the first epoch with
``torch.profiler`` into ``LOGDIR/trace.json``, logs ``profile`` and goes
on from the next epoch. The JAX CLI's ``--data-axis``, ``--graph-axis``
and ``--distributed`` are accepted and refused with the ROADMAP item that
will port them.
"""
from __future__ import annotations

import argparse

from dstagnn_drought_tpu_torch.config import load_config

_NOT_PORTED = {
    "data_axis": "--data-axis: ROADMAP.md §1 item 12 (multi-device)",
    "graph_axis": "--graph-axis: ROADMAP.md §1 item 12 (multi-device)",
    "distributed": "--distributed: ROADMAP.md §1 item 12 (multi-device)",
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a model family (PyTorch/CUDA port)")
    parser.add_argument("--config", default="configurations/PEMS04_dstagnn.conf",
                        help="reference-format INI config path")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override [Training] epochs")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in the run dir")
    parser.add_argument("--experiments-root", default="myexperiments")
    parser.add_argument("--bfloat16", action="store_true",
                        help="bfloat16 compute (params stay float32)")
    parser.add_argument("--use-pallas", action="store_true",
                        help="the CUDA kernel on the Chebyshev-attention path")
    parser.add_argument("--tensorboard", action="store_true",
                        help="write TensorBoard scalars to <run_dir>/tb "
                             "alongside metrics.jsonl")
    parser.add_argument("--profile", metavar="LOGDIR", default=None,
                        help="write a torch.profiler trace of the first epoch "
                             "(LOGDIR/trace.json)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--data-axis", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--graph-axis", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for name, message in _NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(f"not ported yet: {message}")

    cfg = load_config(args.config)
    if args.bfloat16:
        cfg.training.compute_dtype = "bfloat16"
    if args.use_pallas:
        cfg.training.use_pallas = True
    if args.tensorboard:
        cfg.training.tensorboard = True

    from dstagnn_drought_tpu_torch.training.loop import Trainer

    trainer = Trainer(cfg, experiments_root=args.experiments_root, device=args.device)
    if args.resume:
        trainer.resume()
    if args.profile:
        from dstagnn_drought_tpu_torch.training.profiling import trace

        with trace(args.profile):
            loss = trainer.train_epoch(trainer.epoch)  # reading the loss synchronizes
        trainer.logger.log("profile", logdir=args.profile, epoch=trainer.epoch,
                           train_loss=loss)
        trainer.epoch += 1
    result = trainer.run(args.epochs)

    print(f"\nbest epoch: {result['best_epoch']}  val loss: {result['best_val']:.4f}")
    print(f"{'horizon':>7} {'MAE':>8} {'RMSE':>8} {'MAPE%':>8}")
    for row in result["report"]["per_horizon"]:
        print(f"{row['horizon']:>7} {row['mae']:>8.2f} {row['rmse']:>8.2f} "
              f"{row['mape']:>8.2f}")
    o = result["report"]["overall"]
    print(f"{'all':>7} {o['mae']:>8.2f} {o['rmse']:>8.2f} {o['mape']:>8.2f}")
    return result


if __name__ == "__main__":
    main()
