"""STAG construction CLI of the port — counterpart of
``dstagnn_drought_tpu/cli/stag_gen.py`` (Sinkhorn OT, or the PCA
approximation with ``--method fast``).

Usage:
    python -m dstagnn_drought_tpu_torch.cli.stag_gen --input data.npz --dataset GAMBIA \
        [--method fast] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; writes the reference's
``stag_{tag}_{name}.csv``/``strg_{tag}_{name}.csv`` and the STA matrix as
``.npy`` next to the input (or under ``--out-dir``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from dstagnn_drought_tpu_torch.data.stag import generate_stag


def main(argv=None):
    parser = argparse.ArgumentParser(description="STA-graph generator (PyTorch/CUDA port)")
    parser.add_argument("--input", required=True, help="raw signal .npz path")
    parser.add_argument("--dataset", required=True, help="dataset name tag")
    parser.add_argument("--sparsity", type=float, default=0.01)
    parser.add_argument("--method", choices=("sinkhorn", "fast"), default="sinkhorn")
    parser.add_argument("--order", choices=("reference", "similar"), default="reference",
                        help="row-selection semantics; see data/stag.py docstring")
    parser.add_argument("--eps", type=float, default=0.01,
                        help="Sinkhorn entropic regularization")
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--block-size", type=int, default=4096,
                        help="node pairs per device batch")
    parser.add_argument("--out-dir", default=None,
                        help="output directory (default: alongside the input)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with np.load(args.input) as f:
        data = f["data"]
    if data.ndim == 4:
        data = data.squeeze(axis=2)
    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.input))

    t0 = time.time()
    result = generate_stag(
        data, args.dataset, out_dir,
        sparsity=args.sparsity, method=args.method, order=args.order,
        eps=args.eps, num_iters=args.iters, block_size=args.block_size,
        progress=True, device=args.device,
    )
    sta, A, _, (a_path, r_path) = result
    print(f"done in {(time.time() - t0) / 60:.1f} min")
    print(f"STA matrix: {sta.shape}; edges/row: {A.sum(1).mean():.1f}")
    print(f"wrote {a_path}\nwrote {r_path}")
    return result


if __name__ == "__main__":
    main()
