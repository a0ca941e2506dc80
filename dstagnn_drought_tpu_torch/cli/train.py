"""Training CLI of the port — counterpart of ``dstagnn_drought_tpu/cli/train.py``.

Usage:
    python -m dstagnn_drought_tpu_torch.cli.train --config PEMS08.conf \
        [--epochs N] [--resume] [--experiments-root DIR] [--bfloat16] \
        [--use-pallas] [--tensorboard] [--profile LOGDIR] [--device cpu] \
        [--data-axis D] [--graph-axis G] [--distributed]

Trains the config's ``model_name`` (``dstagnn``, ``astgcn``, ``mstgcn``,
``stgcn`` or ``transformer``). Runs on ``cuda`` unless ``--device cpu`` is
given. ``--use-pallas`` keeps the JAX CLI's name and switches DSTAGNN's
Chebyshev aggregation to the CUDA kernel; on the other families, which have
no kernel, it is accepted and changes nothing, as in JAX.
``--tensorboard`` writes TensorBoard scalars to ``<run_dir>/tb`` beside
metrics.jsonl; ``--profile LOGDIR`` traces the first epoch with
``torch.profiler`` into ``LOGDIR/trace.json``, logs ``profile`` and goes
on from the next epoch.

On several ranks, one process each::

    torchrun --nproc_per_node=P -m dstagnn_drought_tpu_torch.cli.train \
        --config C --data-axis D --graph-axis G

``--distributed`` (and either axis flag) initialises the process group from
``torchrun``'s environment when it is present
(:func:`~dstagnn_drought_tpu_torch.parallel.mesh.maybe_initialize_distributed`:
NCCL when every rank has a card of its own, gloo on the CPU or when ranks
share a card); ``--data-axis``/``--graph-axis`` build the mesh, whose
product must be the world size. Only rank 0 writes files and prints.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from dstagnn_drought_tpu_torch.config import load_config


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
    parser.add_argument("--data-axis", type=int, default=None,
                        help="mesh axis size for data parallelism")
    parser.add_argument("--graph-axis", type=int, default=None,
                        help="mesh axis size for node (graph) partitioning")
    parser.add_argument("--distributed", action="store_true",
                        help="initialise torch.distributed from torchrun's "
                             "environment before the mesh is built")
    args = parser.parse_args(argv)

    from dstagnn_drought_tpu_torch.parallel.mesh import (
        make_mesh,
        maybe_initialize_distributed,
    )

    if args.distributed or args.data_axis or args.graph_axis:
        maybe_initialize_distributed()

    cfg = load_config(args.config)
    if args.bfloat16:
        cfg.training.compute_dtype = "bfloat16"
    if args.use_pallas:
        cfg.training.use_pallas = True
    if args.tensorboard:
        cfg.training.tensorboard = True

    mesh = None
    if args.data_axis or args.graph_axis:
        mesh = make_mesh(args.data_axis, args.graph_axis)
        cfg.training.data_axis = mesh.data
        cfg.training.graph_axis = mesh.graph

    from dstagnn_drought_tpu_torch.training.loop import Trainer

    trainer = Trainer(cfg, experiments_root=args.experiments_root, device=args.device,
                      mesh=mesh)
    if args.resume:
        trainer.resume()
    if args.profile and not trainer.writer:
        trainer.train_epoch(trainer.epoch)  # rank 0 alone writes the trace
        trainer.epoch += 1
    elif args.profile:
        from dstagnn_drought_tpu_torch.training.profiling import trace

        with trace(args.profile):
            loss = trainer.train_epoch(trainer.epoch)  # reading the loss synchronizes
        trainer.logger.log("profile", logdir=args.profile, epoch=trainer.epoch,
                           train_loss=loss)
        trainer.epoch += 1
    result = trainer.run(args.epochs)
    if dist.is_initialized() and dist.get_rank() != 0:
        return result

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
