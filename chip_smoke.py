#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dstagnn_drought_tpu_torch) on one GPU.

Usage (from the repository root, on a machine with one CUDA card and nvcc):

    python3 chip_smoke.py [--measure] [--json PATH]

Phases; any failure exits non-zero:
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print the build time, the ptxas report and the card's name and
     power limit;
  2. hold each kernel against its plain PyTorch version on the card (TF32
     off) at the main paths' shapes and at ragged shapes, with CUDA-event
     times of both: cheb_sat forward and gradients at the seven shapes of
     its row (x as the model hands it over: float32 at PEMS08, bf16 at
     GAMBIA) and three in the other x dtype, each row naming its design
     (A and a float32 x split bf16 hi + lo, on the tensor cores) and its
     plan, its output within 1e-4 of scale of the plain float32 version
     where a no-split control (A and x rounded to bf16) is not, equal bit
     for bit over two launches, its float32 and bf16-term bounds, and the
     plan's shared-memory and scratch bytes equal to the kernel's own; the BELL forward (F),
     K1 and K2 at the GAMBIA blocks, the 1%-random N=2139 graph (17 slots a
     tile), a ragged n=29 graph (BS 8 and 16) and the widths past the caps
     the kernels had before (block 2 at C = Co = 128, C = 128 with Co = 256
     at H = 3 on the random graph, BS = 256, d_k = 160, Co = 1024), in
     float32 and bfloat16, with K1's dΘ, F's output and K2's dx equal bit
     for bit over two launches; each row names its design (one for both
     dtypes on the tensor cores, float32 split bf16 hi + lo) and its plan
     and carries the float32 kernel's time at its shape; the float32
     kernels are held against the plain float32 versions within a limit
     that a no-split control (every product operand rounded to bf16)
     exceeds, in F's output, dA, dΘ and dx; the bf16 K1's dΘ is held
     against the plain float32 dΘ within a limit that a no-split control
     exceeds, the bf16 F and K2 differ from the plain bf16 output on at
     most 1% of their outputs where no-split controls differ on more (also
     at five random graphs whose shapes take the kernels' other paths, in
     both dtypes), and the three plans' shared-memory bytes must equal the
     kernels' own in both dtypes, past the old caps too;
  2c. the fused dense kernels against their plain versions, forward and
     every gradient, in float32 and bfloat16, at PEMS08 block 1 and blocks
     2-4, the TAt embedding mode, ragged shapes, PEMS07's N = 883, the TAt
     at GAMBIA's T = 144, N = 4096 and 8600 at T = 12 and T = 576 and 1024
     at N = 170 (the shapes the whole-row passes refused; with and
     without the embedding), and the spatial middle at GAMBIA's blocks 1-2
     and a ragged N = 1001; both at the head and channel widths past the
     old caps (TAT_WIDE_SHAPES, SPATIAL_WIDE_SHAPES: phase 3f's blocks, d_k
     = d_v = 256 and 512 at T = 48, H·d_v = 4096, the SAt's d_k = 512): the
     temporal-attention forward and backward
     (csrc/tat_fused.cu; one design in both dtypes, passes over all B·F·T
     rows on the tensor cores with the hi/lo split, N streamed in column
     chunks and T in query tiles and key chunks; the float32 rows are
     held against the plain float32 version within a limit that a
     no-split control exceeds; the passes' shared-memory bytes equal to the
     kernels' own) and the spatial-middle forward and backward
     (csrc/block_spatial_fused.cu, source- and target-tiled; the backward
     on the forward's ReLU mask; the N²·C·T products on the tensor cores,
     split hi/lo in float32, the float32 rows held against the plain
     float32 version within a limit that a no-split control exceeds; each
     row naming its design and the float32 time of its shape), every
     weight gradient equal bit for bit over two
     backward launches, and the spatial gate's shared-memory bytes and time
     chunks equal to the kernels' own;
  2d. the fused GTU forward and backward (csrc/gtu_fused.cu; channel
     groups, C in chunks, time tiles with a halo) against their plain
     version at the GAMBIA block, the JAX test's two shapes, a ragged one,
     C = 48 and 80, and at GAMBIA's B·N = 8556 T = 288 and 576 at C = 32
     and C = 64 and 128 at T = 144 (the shapes the card refused before PR
     20), float32 and bfloat16 (both on the tensor cores, float32 split
     hi/lo), dW and db equal bit for bit over two launches, with the
     conv-only cuDNN call timed beside them; each row names its design, and
     the plan's tiling and shared-memory bytes must equal the kernels' own;
  3. the dense main path at full PEMS08 width: the training CLI, two epochs
     on benchmarks/parity_runs/parity_dataset.npz through the kernel, with
     the kernel's launch count read around the run;
  3b. the fused main path: the same CLI run with fuse_tat, fuse_spatial and
     bfloat16, each TAt/spatial kernel once per block of every forward pass
     (forward) or train step (backward), cheb_sat never; then the fused and
     unfused models on one test batch in float32 from the run's checkpoint;
  3c. the CLI with fuse_tat and fuse_spatial at PEMS07 width (N = 883,
     batch 12, a seeded synthetic dataset and edge-list graph), 2 epochs in
     float32 and 2 in bfloat16, the launch counts checked as in 3b, and the
     float32 run's fused and unfused models on one test batch;
  3d. The large-N path (phase_large_n): the CLI on LargeST California's
     N = 8600 at PEMS08 widths (seeded synthetic windows, batch 16, a
     seeded 8-nearest-neighbour graph), BELL tiles of 128 with rcm and
     fuse_tat, 2 epochs in float32 and 2 in bf16, the TAt and BELL
     launches checked, the float32 run's model against its unfused (plain
     TAt) twin on one test batch, then an epoch each for ms/step, epoch
     peak memory, device ms/step and the busy share;
  3e. The long-T path (phase_long_t): the CLI at PEMS08 width on two
     days of five-minute readings (T = 576, batch 8) with fuse_tat,
     fuse_spatial and fuse_gtu, the same checks and measurements, the
     float32 model against the model with all three knobs off;
  3f. the wide path (phase_wide_fused): the CLI with fuse_tat and
     fuse_spatial at the GAMBIA configuration with 8 heads of d_k = d_v =
     128 and at PEMS08 width with C = Co = 512, d_model = 4096 and 8 heads
     of 128, 2 epochs each in float32 and bf16, the launches checked per
     block and the float32 runs' fused models against the unfused ones;
  4. GAMBIA dense (N=2139, F=4, T=144, bfloat16): training steps through
     the Trainer, the kernel at N > 1024 and the multichannel/long-T tail;
  4b. the GTU slice's main path: GAMBIA dense with fuse_gtu = true,
     Trainer.run for 2 epochs, the GTU forward and cheb_sat once per block
     of every forward pass, the GTU backward once per block of every train
     step; then the fused and im2col tails on one test batch in float32
     and in bfloat16 (predictions checked, the GTU weight gradients
     reported);
  5. the block-sparse main path: bench.py's GAMBIA bell_tiles
     configuration (sparse, bell, use_pallas, mask_format=tiles, BS=128,
     bfloat16), Trainer.run for 2 epochs of 3 steps, F once per block of
     every forward pass and K1/K2 once per block of every train step;
  5b. the same BELL tiles configuration with fuse_gtu = true, one epoch,
     the GTU and BELL launch counts checked;
  6. GAMBIA BELL with dense masks and rcm=true, one epoch, its test
     predictions held against an unpermuted model in the original order;
  6b. the full-width BELL path (``phase_gambia_wide``): the training CLI at
     the bell_tiles configuration with nb_chev_filter = nb_time_filter =
     128 (block 2's conv at C = Co = 128), 2 epochs of 3 steps in float32 and 2 in bf16,
     finite falling losses, a checkpoint, the report and the F/K1/K2 launch
     counts; the float32 checkpoint's predictions on one test batch against
     the same weights through the plain BELL forward; an epoch each for
     ms/step and epoch peak memory and a profiled one for device ms/step
     and the busy share;
  7. the graph pipeline's STAG construction at GAMBIA's shapes (T=287,
     F=4): the fast PCA variant at N=2139, the Sinkhorn STAG of the first
     128 nodes (8,128 pairs, 200 iterations) through the stag_gen CLI, its
     CSVs read back, its first 16 nodes held against the port's own CPU run;
     pairs/s and peak memory (torch ops, no kernel);
  8. the ELL trainer at the GAMBIA configuration (sparse, sparse_format=ell,
     bf16): Trainer.run for 2 epochs of 3 steps on the grid graph, falling
     losses, no kernel launched, the aggregation branch each block took
     (one-shot gather or slot loop) beside its gather bytes, ms/step and
     epoch peak memory; then one epoch on the 1%-random N=2139 graph;
  9. the model zoo at PEMS08 width (phase_zoo): ASTGCN, MSTGCN, STGCN and
     the Transformer each through the training CLI for 2 epochs in float32
     (falling losses, no kernel launched), one test batch from the last
     checkpoint on the card against the same weights on the CPU (2e-4 of
     scale), ms/step, epoch peak memory and the busy share of a profiled
     epoch; one bf16 epoch of ASTGCN and of the Transformer; a ``zoo`` line
     per run;
  10. remat (``phase_remat``): GAMBIA dense at full width (bf16,
     use_pallas, fuse_gtu) and PEMS08 width fused (fuse_tat, fuse_spatial,
     bf16), each without and with remat from one seed, both graphed: the
     epoch losses within 1e-6 (bit equality printed), the forward kernels
     launched twice per block of every train step under remat (the
     recompute, inside the graph) and once without,
     the backward kernels once, each side's ms/step and epoch peak memory;
  11. debug mode (``phase_debug``, PEMS08 width, float32, use_pallas): three
     checked steps with losses equal to the eager steps' bit for bit, then
     an inf in a Chebyshev plane that only the cheb_sat kernel reads (named
     by the kernel, at its first launch), a NaN input sample (named by the
     gather that emits it) and an index outside the split (refused before
     the gather; a step after it still runs); the checked step's time
     against the eager step's;
  12. NaN rollback (``phase_rollback``, GAMBIA BELL tiles, bf16): a NaN
     weight at the start of epoch 1, exactly one rollback, the model, Adam
     state and generator equal to epoch 0's checkpoint and the lr halved in
     every param group, a finite test loss, F/K1/K2 counted over every step
     actually run;
  13. the evaluate CLI (``phase_evaluate``) with ``--use-pallas
     --export-attention`` on phase 3's best checkpoint (predictions equal to
     the run's dump, four finite (3, 170, 170) maps, the CSV, the maps equal
     to the CPU's, cheb_sat once per block of every forward), then the
     train CLI with ``--profile`` and ``--tensorboard`` (the trace must name
     a cheb_sat kernel);
  14. multi-device training (``phase_multi``, the parallel package): 4
     ranks share the card over gloo (NCCL refuses two ranks on one card;
     gloo takes every collective the port issues on CUDA tensors, nothing is
     staged through host memory) and train GAMBIA BELL tiles and GAMBIA
     dense at full width, the node axis sharded over 'graph' from the batch
     to the loss (each rank its Np/P node rows; EmbedT, the TAt and the
     pre-conv, and the dense spatial middle, whole inside node-row regions
     that keep their inputs' rows and run again in the backward), one
     eager epoch of 3 steps and one eval each: BELL tiles at graph = 4
     with the overlapped halo in float32, in bf16 and in bf16 with
     fuse_gtu and fuse_tat, (data, graph) = (2, 2) without it in float32,
     dense (use_pallas, dropout 0.05) at graph = 4 in float32; each held
     against the eager single-rank run of the same weights in this call
     (per-step losses, the first step's gradients gathered whole at each
     tensor's own scale, final weights, val predictions; each rank's
     gradient before the graph- or data-group sum must fail that gate),
     each rank's epoch activation peak (at most 0.4 of the single run's in
     every BELL-tiles run at graph = 4, 0.5 in the dense one), the
     parameters every rank holds whole bit-identical across ranks, each
     rank's F once per block of every forward pass and K1/K2 once per block
     of every step (twice with the overlap's two sublists), the GTU kernels
     so and the TAt's forward once more in the backward in the fused run,
     cheb_sat once per block of every forward pass and of every step's
     backward in the dense run; rank 0's F, K1 and K2 against their plain
     versions at its shard shapes and the GTU at its node rows (both dtypes),
     a sublist's pad entries exactly 0 (F rows zero, K1's dΘ and K2's dx
     unchanged bit for bit without them) and the plan's inert tiles finite
     and zero; the targeted exchange's volume at graph = 2 and 4; ms/step
     of 4 ranks sharing one H100 (no multi-GPU figure); then the training
     CLI with --distributed at world size 1 under NCCL, its predictions
     equal bit for bit to the run without it;
  15. the whole-epoch runners as CUDA graphs (``phase_graphed``): GAMBIA
     dense (use_pallas, fuse_gtu), GAMBIA BELL tiles (fuse_gtu) and PEMS08
     width fused (fuse_tat, fuse_spatial), each in float32 and bf16, two
     epochs and a val pass through the eager loop and then through the
     graphs from the same weights and seed: per-step losses, weights and
     val predictions the same bits (or within the spread of a second eager
     run), the launches the graphs ran (``launches_run``: each capture's
     launches once a replay, from ``graph_stats``) equal the eager run's
     and the expected counts, one train graph replayed for every step but
     the warm-up and one val graph for every batch but the first; in bf16
     the two alternated over two rounds for wall ms/step, and a profiled
     epoch of each whose traces name the same csrc kernels the same number
     of times (a pair that differs is profiled once more, and the second
     pair must agree); a resume that must capture again
     (its losses against an eager trainer loading the same checkpoint); the
     eager losses with and without capturable Adam; what a capture says of
     a constant copied from the host (the pattern ops/ no longer has);
  16. a JSON line with every kernel's numbers (with F, K1 and K2 on rank
     0's tile list at graph = 4, and the GTU on its node rows, as records
     of their own), then the device line.

Every single-rank Trainer of these phases trains and evaluates through
CUDA graphs; the launch checks count a graph's captured launches once per
replay (``launches_run``), the wrappers' counters count the warm-up step and
the capture. Phase 12's rollback must capture a new train graph, whose
losses equal an eager trainer's resumed from the same checkpoint at the
halved lr. Mesh runs (phase 14) and debug mode (phase 11) stay eager.

``--measure`` adds the spatial and TAt forward and backward by pass
(profiles at PEMS08 blocks 2-4 in both dtypes; the TAt's plain version's
device time beside its CUDA-event time), timings of whole training epochs (PEMS08 width, the
fused PEMS08-width bf16 trainer against both unfused paths, the fused
PEMS07-width trainer in float32 and bf16 against both unfused paths
(``measure_fused_steps``), GAMBIA dense,
GAMBIA BELL tiles against both dense paths, and GAMBIA dense and BELL tiles
with the fused GTU tail against the im2col tail; the fused PEMS08 and
PEMS07 and the GTU comparisons with each epoch's peak device memory)
alternated in one process, a torch.profiler breakdown of
each, a 25-epoch PEMS08 accuracy run of both dense paths checked
against the reference model's recorded test MAE, and the Sinkhorn STAG of
all 2,286,591 GAMBIA pairs (``measure_stag_full``). The epoch profiles also
rank the host ops by their inputs' shapes. Callable alone, outside the run:
``measure_multi`` (phase 14's runs without their gates: peak shares,
ms/step, gradient errors; copied into an older checkout, it measures that
one too, so two commits alternate in one call) and
``measure_graph_split_floor`` (the float32 single run with the TAt's
projections summed as 4 rank chunks of N, against itself unsplit) and
``measure_gloo_gather`` (the all-gather of x's rows a region makes, timed
alone on the 4 ranks). ``--rows OUT`` builds and
times only PERF.md rows 2-13 at their main shapes (``measure_rows``: F,
K1 and K2 at GAMBIA blocks 1-2 and the 17-slot random graph by pass with
their outputs' digests, the TAt, spatial middle and GTU by CUDA events,
the TAt's and spatial middle's outputs' digests; from another
commit's checkout, as ``--compare``). ``--compare OUT`` builds
and runs only ``compare_run``: one side of a comparison with another
commit's checkout (the float32 spatial, TAt, K1, K2 and F kernels' bits,
cheb_sat at its four main shapes, F, K1 and K2 by pass at GAMBIA blocks
1-2 and on the 17-slot random graph, the GAMBIA dense and BELL-tiles
bf16 epochs with and without fuse_gtu, with epoch peak memory).

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from dstagnn_drought_tpu_torch.cli import stag_gen
from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.data.adjacency import load_stag_adjacency, load_strg_adjacency
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.data.stag import fast_sta_matrix, sta_matrix
from dstagnn_drought_tpu_torch.models.dstagnn import permute_nodes
from dstagnn_drought_tpu_torch.ops import sparse
from dstagnn_drought_tpu_torch.ops.block_sparse import block_ell_from_adjacency
from dstagnn_drought_tpu_torch.ops.cuda import (
    bell_bwd,
    bell_fused,
    block_spatial_fused,
    build,
    cheb_sat,
    gtu_fused,
    tat_fused,
)
from dstagnn_drought_tpu_torch.training.loop import Trainer

REPO = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): float32 on the CUDA cores
# and HBM3 bandwidth; at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12
TOL = 2e-4       # forward, kernel vs plain (precedent tests/test_pallas_cheb.py)
GRAD_TOL = 5e-3  # gradients (precedent tests/test_pallas_cheb.py)
# cheb_sat's gradients are checked at the seven shapes of the PERF.md row
GRAD_SHAPES = ("pems08_block1", "pems08_blocks2-4", "gambia_block1", "gambia_block2",
               "ragged_n7", "ragged_n130", "ragged_n33")


def reset_launches():
    cheb_sat.launches = bell_fused.launches = 0
    bell_bwd.k1_launches = bell_bwd.k2_launches = 0
    tat_fused.fwd_launches = tat_fused.bwd_launches = 0
    block_spatial_fused.fwd_launches = block_spatial_fused.bwd_launches = 0
    gtu_fused.fwd_launches = gtu_fused.bwd_launches = 0


def read_launches() -> dict:
    return {"cheb_sat": cheb_sat.launches, "bell_fused": bell_fused.launches,
            "bell_k1": bell_bwd.k1_launches, "bell_k2": bell_bwd.k2_launches,
            "tat_fwd": tat_fused.fwd_launches, "tat_bwd": tat_fused.bwd_launches,
            "spatial_fwd": block_spatial_fused.fwd_launches,
            "spatial_bwd": block_spatial_fused.bwd_launches,
            "gtu_fwd": gtu_fused.fwd_launches, "gtu_bwd": gtu_fused.bwd_launches}


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


class trainers_made:
    """Inside the block, every Trainer built (the CLIs build their own) is
    appended to the list the block yields, for its ``graph_stats``."""

    def __enter__(self) -> list:
        self.made, self.init = [], Trainer.__init__

        def init(tr, *a, **k):
            self.init(tr, *a, **k)
            self.made.append(tr)

        Trainer.__init__ = init
        return self.made

    def __exit__(self, *exc):
        Trainer.__init__ = self.init


def graph_summary(trainer) -> list:
    """The trainer's CUDA graphs: kind, replays, capture ms and the
    launches each replay runs (nonzero counters only)."""
    return [{"graph": r["graph"], "replays": r["replays"], "capture_ms": r["capture_ms"],
             "per_replay": {k: n for k, n in r["captured"].items() if n}}
            for r in trainer.graph_stats]


def graph_snapshot(trainers) -> dict:
    """The trainers' graph records as they stand: {id: [records]}."""
    return {id(tr): [dict(r) for r in tr.graph_stats] for tr in trainers}


def launches_run(counts: dict, trainers, before: dict | None = None) -> dict:
    """The kernel launches that ran on the card since the counters were
    set to 0 (``counts``, read now): a wrapper counts each eager call and
    each capture, which runs nothing, and a CUDA graph of ``trainers``
    (their ``graph_stats``) runs its captured launches at every replay.
    ``before`` is :func:`graph_snapshot` at the reset (none: the trainers
    were built after it)."""
    out = dict(counts)
    for tr in trainers:
        old = (before or {}).get(id(tr), [])
        for i, r in enumerate(tr.graph_stats):
            runs = r["replays"] - (old[i]["replays"] if i < len(old) else 1)
            for k, n in r["captured"].items():
                out[k] += n * runs
    return out


TIMING_BUDGET_MS = 250.0  # timed calls of one cuda_ms, so that a slow shape costs two


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, after a warm-up of two
    calls: ``iters`` calls, or as many (at least 2) as the second warm-up
    call says fit in TIMING_BUDGET_MS."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    n = max(2, min(iters, int(TIMING_BUDGET_MS / max(once, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

CHEB_SAT_SHAPES = [
    # (label, B, K, N, M, x dtype): the main path's shapes with x as the
    # model hands it over (PEMS08 float32, GAMBIA bf16), then the ragged
    # shapes of tests/test_pallas_cheb.py::test_unaligned_shapes
    ("pems08_block1", 64, 3, 170, 12, torch.float32),
    ("pems08_blocks2-4", 64, 3, 170, 384, torch.float32),
    ("gambia_block1", 4, 2, 2139, 576, torch.bfloat16),
    ("gambia_block2", 4, 2, 2139, 4608, torch.bfloat16),
    ("ragged_n7", 1, 2, 7, 12, torch.float32),
    ("ragged_n130", 1, 2, 130, 15, torch.float32),
    ("ragged_n33", 1, 2, 33, 18, torch.float32),
    # the other x dtype: three products at GAMBIA, two at PEMS08, and a
    # bf16 x with M % 8 != 0 (rewritten as a padded plane)
    ("gambia_block2_x_f32", 4, 2, 2139, 4608, torch.float32),
    ("pems08_blocks2-4_x_bf16", 64, 3, 170, 384, torch.bfloat16),
    ("ragged_n130_x_bf16", 1, 2, 130, 15, torch.bfloat16),
    # the 16-warp product at one tile of 256 features, 64 and 128 targets a
    # block
    ("tm256_n300", 1, 2, 300, 256, torch.float32),
    ("tm256_n1000", 2, 2, 1000, 240, torch.bfloat16),
]
# the main path's shapes, in the order of the PERF.md row
CHEB_SAT_MAIN = ("pems08_block1", "pems08_blocks2-4", "gambia_block1", "gambia_block2")
CHEB_SAT_DESIGN = "wmma_bf16_split"  # A (and a float32 x) split bf16 hi + lo, on WMMA
# the kernel's output against the plain float32 version on the same
# operands, as max |Δ| over max |plain|: the design splits A and a float32 x
# into bf16 hi + lo (float32 in value), a design without the lo planes
# (sat_nosplit_plain) rounds A and x to bf16 before the product
SAT_SPLIT_TOL = 1e-4


def cheb_sat_bound(B, K, N, M, x_bytes=4, products=1):
    """(ms, by) of the least time at (B, K, N, M): the operations against
    the bytes (S, x once, the out written once, bias and T once). With
    ``products`` (the design's bf16 products a product) the operations run
    at the bf16 tensor-core peak, else (0) as float32 on the CUDA cores."""
    flops = 2 * B * K * N * N * M
    nbytes = 4 * (B * K * N * N + 2 * K * N * N + B * K * N * M) + x_bytes * B * N * M
    t_ops = products * flops / PEAK_BF16_FLOPS if products else flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cheb_sat_inputs(B, K, N, M, seed, x_dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    scores = torch.randn(B, K, N, N, generator=g, device=dev)
    adj_pa = (torch.rand(N, N, generator=g, device=dev) < 0.3).float()
    masks = torch.randn(K, N, N, generator=g, device=dev)
    cheb = torch.randn(K, N, N, generator=g, device=dev)
    x = torch.randn(B, N, M, generator=g, device=dev).to(x_dtype)
    return scores, (adj_pa[None] * masks).contiguous(), cheb, x


def sat_nosplit_plain(s, bias, cheb, x):
    """The control of the split check: the plain version with A and x
    rounded to bf16 before the product (float32 sums)."""
    p = torch.softmax(s + bias[None], dim=2)
    a = (cheb[None] * p).bfloat16().float()
    return torch.einsum("bkij,bim->bkjm", a, x.bfloat16().float())


def check_sat_smem():
    """cheb_sat.sat_plan's shared-memory and scratch bytes against the
    kernel's own (cheb_sat_smem_bytes, cheb_sat_scratch_bytes) at every
    cheb_sat shape in both x dtypes, and sat_smem_bytes at every tile the
    kernel takes; every plan fits its blocks an SM (two at 8 warps, one at
    16). Returns the number of plans checked."""
    lib = cheb_sat._load()
    for tj in (64, 128):
        for tm in (16, 32, 64, 128, 256):
            for xs in (0, 1):
                for ns in (2, 3, 4):
                    got = cheb_sat.sat_smem_bytes(tj, tm, xs, ns)
                    want = lib.cheb_sat_smem_bytes(tj, tm, xs, ns)
                    check(got == want, f"sat_smem_bytes({tj}, {tm}, {xs}, {ns}) = {got}, "
                                       f"the kernel requests {want}")
    n = 0
    for _, B, K, N, M, _ in CHEB_SAT_SHAPES:
        for bf in (False, True):
            plan = cheb_sat.sat_plan(B, K, N, M, bf)
            want = (lib.cheb_sat_smem_bytes(plan["tj"], plan["tm"], 0 if bf else 1,
                                            plan["stages"]),
                    lib.cheb_sat_scratch_bytes(B, K, N, M, int(bf)))
            check((plan["smem"], plan["scratch"]) == want
                  and plan["smem"] <= cheb_sat._SMEM_LIMIT[plan["warps"]],
                  f"sat_plan({B}, {K}, {N}, {M}, {bf}) = {plan}; the kernel's bytes {want}")
            n += 1
    return n


def phase_kernels():
    n_plans = check_sat_smem()
    rows = []
    for seed, (label, B, K, N, M, xdt) in enumerate(CHEB_SAT_SHAPES):
        s, bias, cheb, x = cheb_sat_inputs(B, K, N, M, seed, xdt)
        got = cheb_sat.sat_aggregate_cuda(s, bias, cheb, x)
        want = cheb_sat.sat_aggregate_plain(s, bias, cheb, x)
        control = sat_nosplit_plain(s, bias, cheb, x)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        ok = bool(torch.allclose(got, want, atol=TOL, rtol=TOL)) and rel <= TOL
        plan = cheb_sat.sat_plan(B, K, N, M, xdt == torch.bfloat16)
        split = {"kernel": rel, "nosplit": rel_err(control, want)[1], "tol": SAT_SPLIT_TOL}
        split["ok"] = split["kernel"] <= SAT_SPLIT_TOL < split["nosplit"]
        row = {"shape": label, "B": B, "K": K, "N": N, "M": M,
               "x_dtype": str(xdt).split(".")[-1], "design": CHEB_SAT_DESIGN,
               "plan": plan, "smem_check": f"{n_plans} plans equal the kernel's bytes",
               "max_abs_err": err, "rel_err": rel, "ok": ok, "split_check": split,
               "bit_identical": bool(torch.equal(got, cheb_sat.sat_aggregate_cuda(s, bias, cheb,
                                                                                   x)))}
        del control
        if label in GRAD_SHAPES:
            row["grad_max_abs_err"] = grad_error(s, bias, cheb, x)
        iters = 5 if N > 1024 else 20
        row["ms"] = cuda_ms(lambda: cheb_sat.sat_aggregate_cuda(s, bias, cheb, x), iters)
        row["plain_ms"] = cuda_ms(lambda: cheb_sat.sat_aggregate_plain(s, bias, cheb, x), iters)
        row["bound_ms"], row["bound_by"] = cheb_sat_bound(B, K, N, M, x.element_size(),
                                                          plan["products"])
        row["f32_bound_ms"], row["f32_bound_by"] = cheb_sat_bound(B, K, N, M, x.element_size(),
                                                                  0)
        print("cheb_sat", json.dumps(row), flush=True)
        check(ok, f"cheb_sat kernel vs plain at {label}: max |d| {err:.3g} ({rel:.3g} of "
                  f"scale) > {TOL}")
        check(split["ok"], f"cheb_sat split check at {label}: {split}")
        check(row["bit_identical"], f"cheb_sat output differs over two launches at {label}")
        if "grad_max_abs_err" in row:
            check(row["grad_max_abs_err"] <= GRAD_TOL,
                  f"cheb_sat gradients at {label}: {row['grad_max_abs_err']:.3g}")
        rows.append(row)
        del s, bias, cheb, x, got, want
    return rows


# kernel-name fragments of each cheb_sat pass ("product": the tensor-core
# kernel, or an older version's CUDA-core aggregate_kernel)
SAT_PASSES = (("stats", ("colstats_kernel",)), ("form", ("form_kernel",)),
              ("x_planes", ("x_planes_kernel",)),
              ("product", ("sat_wmma_kernel", "aggregate_kernel")))


def measure_cheb_sat(iters: int = 10) -> dict:
    """cheb_sat at the four main shapes, x in the main path's dtype: the
    kernel and the plain version by CUDA events, and the kernel's device
    time by pass (torch.profiler; "other" is the wrapper's allocations and
    casts). A version of the package whose kernel (and plain version)
    takes float32 x only is timed with the cast the model's wrapper then
    makes (``x_cast``). For ``--compare``."""
    out = {}
    for seed, (label, B, K, N, M, xdt) in enumerate(CHEB_SAT_SHAPES):
        if label not in CHEB_SAT_MAIN:
            continue
        s, bias, cheb, x = cheb_sat_inputs(B, K, N, M, seed, xdt)
        try:
            cheb_sat.sat_aggregate_cuda(s, bias, cheb, x)
            cast = False
        except TypeError:
            cast = True
        xx = (lambda: x.float()) if cast else (lambda: x)
        run = lambda: cheb_sat.sat_aggregate_cuda(s, bias, cheb, xx())
        n = iters if N > 1024 else 4 * iters
        out[label] = {"ms": cuda_ms(run, n), "x_dtype": str(xdt).split(".")[-1],
                      "x_cast": cast,
                      "plain_ms": cuda_ms(lambda: cheb_sat.sat_aggregate_plain(s, bias, cheb,
                                                                               xx()), n),
                      **_profile_passes(run, n, SAT_PASSES)}
        del s, bias, cheb, x
    print("measure_cheb_sat", json.dumps(out), flush=True)
    return out


def grad_error(s, bias, cheb, x) -> float:
    """Max |Δ| (relative to each gradient's scale) between the
    autograd.Function (kernel forward, tensor-op backward) and autograd
    through the plain composition."""
    g = torch.randn(s.shape[0], s.shape[1], s.shape[2], x.shape[-1],
                    device=s.device, generator=torch.Generator(device="cuda").manual_seed(7))
    worst = 0.0
    grads = []
    for fn in (cheb_sat.SatAggregate.apply, cheb_sat.sat_aggregate_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (s, bias, x)]
        out = fn(leaves[0], leaves[1], cheb, leaves[2])
        (out * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), 1.0)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


# ---------------------------------------------------------------------------
# phase 2b: the BELL kernels (fused forward, K1, K2) vs their plain versions
# ---------------------------------------------------------------------------

BELL_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}  # bf16: ~2.5 ulps (2^-8 each)


def grid_adjacency(nx: int = 93, ny: int = 23) -> np.ndarray:
    """The 4-neighbour grid graph of gambia_data (N = nx·ny)."""
    N = nx * ny
    A = np.zeros((N, N), np.float32)
    idx = np.arange(N).reshape(nx, ny)
    A[idx[:-1].ravel(), idx[1:].ravel()] = 1
    A[idx[:, :-1].ravel(), idx[:, 1:].ravel()] = 1
    return np.maximum(A, A.T)


def random_adjacency(n: int, density: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, n)) < density).astype(np.float32)


BELL_SHAPES = [
    # (label, graph, B, H, C, T, Co, BS, d_k): the GAMBIA blocks on the grid
    # graph (A=49, at most 3 slots a tile), the 1%-random graph at N=2139
    # (A=289, 17 slots a tile: the long slot loop) and a ragged small graph
    ("gambia_block1", "grid", 4, 2, 4, 144, 32, 128, 32),
    ("gambia_block2", "grid", 4, 2, 32, 144, 32, 128, 32),
    ("random1pct_n2139", "random", 4, 2, 4, 144, 32, 128, 32),
    ("ragged_n29_bs8", "ragged", 2, 2, 4, 12, 8, 8, 8),
    ("ragged_n29_bs16", "ragged", 2, 2, 4, 12, 8, 16, 8),
    # one input channel (the PEMS-style first block) at long T, K=3 heads
    ("ragged_n29_c1_t144", "ragged", 2, 3, 1, 144, 32, 16, 8),
    # the widths past the caps the kernels had before: GAMBIA block 2 at C =
    # Co = 128 (nb_chev_filter = 128), C = 128 with Co = 256 at H = 3 on the
    # 17-slot random graph (T cut to 16 so the plain versions fit), block 2
    # at BS = 256 (A = 23) and at d_k = 160, and Co = 1024 on a ragged graph
    ("gambia_block2_c128", "grid", 4, 2, 128, 144, 128, 128, 32),
    ("random1pct_c128_co256_h3", "random", 2, 3, 128, 16, 256, 128, 32),
    ("gambia_block2_bs256", "grid", 4, 2, 32, 144, 32, 256, 32),
    ("gambia_block2_dk160", "grid", 4, 2, 32, 144, 32, 128, 160),
    ("ragged_co1024", "ragged", 2, 2, 4, 12, 1024, 16, 8),
]
BELL_NEW_SHAPES = ("gambia_block2_c128", "random1pct_c128_co256_h3", "gambia_block2_bs256",
                   "gambia_block2_dk160", "ragged_co1024")


def bell_graph(kind: str, BS: int):
    adj = {"grid": grid_adjacency, "random": lambda: random_adjacency(2139, 0.01, 1),
           "ragged": lambda: random_adjacency(29, 0.25, 2)}[kind]()
    return block_ell_from_adjacency(adj, block_size=BS).to("cuda")


def bell_bounds(B, H, A, BS, dk, C, T, Co, Np, dtype):
    """(bound_ms, bound_by, flops) of F, K1 and K2: operations over the
    tensor cores' bf16 peak (989 TFLOP/s; every product of the BELL kernels
    runs there in both dtypes) against the bytes each function must move
    over 3.35 TB/s, every operand read or written once: F reads q, k (f32),
    the bias and cheb tiles (f32), x and Θ and writes out; K1 reads gm, x,
    w and Θ and writes dA (f32) and dΘ; K2 reads gm, w and Θ and writes dx.
    A float32-in-value product counts its bf16 terms, as tat_bounds does:
    F's scores (float32 q, k) and Θ mix (float32 agg and Θ) three each in
    both dtypes, its SpMM one in bf16; K2's g_agg and dx two each in bf16;
    K1 one in bf16; in float32 every product three (both operands split
    hi + lo)."""
    M, xb = C * T, (2 if dtype == torch.bfloat16 else 4)
    f32 = dtype == torch.float32
    spmm, k1_terms, k2_terms = (3, 3, 3) if f32 else (1, 1, 2)
    ops = {"bell_fused": (2 * B * H * A * BS * BS * (3 * dk + spmm * M)
                          + 3 * 2 * B * Np * H * M * Co),
           "bell_k1": k1_terms * (4 * B * H * A * BS * BS * M + 4 * B * Np * H * M * Co),
           "bell_k2": k2_terms * (2 * B * H * A * BS * BS * M + 2 * B * H * A * BS * M * Co)}
    x_b, g_b, w_b = xb * B * Np * M, xb * B * Np * Co * T, xb * B * A * H * BS * BS
    theta_b = 4 * H * C * Co
    nbytes = {"bell_fused": 4 * 2 * B * Np * H * dk + 4 * 2 * A * H * BS * BS + x_b + g_b
              + theta_b,
              "bell_k1": g_b + x_b + w_b + theta_b + 4 * B * A * H * BS * BS + theta_b,
              "bell_k2": g_b + w_b + theta_b + x_b}
    out = {}
    for name in ops:
        t_ops, t_bytes = ops[name] / PEAK_BF16_FLOPS, nbytes[name] / PEAK_HBM_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                     ops[name])
    return out


def bell_inputs(bell, B, H, C, T, Co, dk, dtype, seed):
    """Random kernel operands in the kernels' layouts, with w and gm made
    the way the backward makes them (softmax weights rounded to dtype)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    t = bell.tensors
    A, BS, Np = bell.num_active, bell.block_size, bell.padded_nodes
    n = bell.n_nodes
    pattern = t["active_pattern"][:, None]                      # (A, 1, BS, BS)
    rows = (torch.arange(Np, device=dev) < n).float()[None, :, None]
    q = torch.randn(B, Np, H, dk, generator=g, device=dev)
    k = torch.randn(B, Np, H, dk, generator=g, device=dev)
    bias = torch.where(pattern, torch.randn(A, H, BS, BS, generator=g, device=dev),
                       torch.tensor(-1e30, device=dev)).contiguous()
    cheb = (torch.randn(A, H, BS, BS, generator=g, device=dev) * pattern).contiguous()
    x = (torch.randn(B, Np, C * T, generator=g, device=dev) * rows).to(dtype).contiguous()
    thetas = (torch.randn(H, C, Co, generator=g, device=dev) * 0.1).contiguous()
    gm = torch.randn(B, Np, Co * T, generator=g, device=dev)
    gm = (gm * (gm > -0.5) * rows).to(dtype).contiguous()
    _, _, att = bell_fused.active_softmax(q, k, bias, t["active_src"], t["active_tgt"],
                                          bell.num_tiles)
    w = (cheb[None] * att * pattern[None]).to(dtype).contiguous()
    return dict(q=q, k=k, bias=bias, cheb=cheb, x=x, thetas=thetas, gm=gm, w=w)


def rel_err(got, want) -> tuple[float, float]:
    """(max |Δ|, max |Δ| over max(1, max |plain|)) in float32."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(1.0, float(want.float().abs().max()))


def bell_design(name, dtype) -> str:
    """The arithmetic of a BELL kernel: one design for both dtypes, every
    product on the tensor cores (WMMA): F (weights_kernel, then
    f_spmm_wmma_kernel<RF, CW, HG, T>), K1 (k1_dA_wmma_kernel,
    k1_dtheta_wmma_kernel, dense::sum_rows) and K2 (k2_theta_split_kernel,
    then k2_wmma_kernel); bf16 operands as they are, float32 ones split into
    bf16 hi + lo (three products where two float32 values meet)."""
    return "wmma_bf16" if dtype == torch.bfloat16 else "wmma_f32_split"


# (BS, C, Co, T, H, d_k) at which the plans' bytes are held against the
# kernels' own: every BELL shape, the corner shapes, and the edges past the
# caps the kernels had before (C 65/128/256, Co 129/513/1024, BS 136/160/
# 256, d_k 128/129/160/512, H 6)
SMEM_EDGES = [(BS, C, Co, T, H, dk) for BS in (8, 120, 136, 256) for C in (1, 5, 32, 65, 128)
              for Co in (1, 32, 129, 1024)
              for T, H, dk in ((7, 3, 8), (144, 2, 32), (16, 6, 160))] + [
    (128, 32, 32, 144, 2, dk) for dk in (128, 129, 512)]


def bell_smem_shapes():
    return sorted({(s[7], s[4], s[6], s[5], s[3], s[8]) for s in BELL_SHAPES}
                  | {(s[3], s[6], s[8], s[7], s[5], s[9]) for s in BELL_CORNER_SHAPES}
                  | set(SMEM_EDGES))


def check_f_smem():
    """bell_fused.f_wmma_smem_bytes, f_wmma_stage_bytes and
    f_weights_smem_bytes (the Python mirrors) against the bytes the kernels
    of csrc/bell_fused.cu request, in both dtypes, at every BELL shape and
    past the old caps, for f_plan's own tiles and their neighbours; every
    plan fits a block."""
    lib = bell_fused._load()
    for BS, C, Co, T, H, dk in bell_smem_shapes():
        got = bell_fused.f_weights_smem_bytes(dk)
        want = lib.bell_fused_wmma_smem_bytes(0, dk, 0, 0, 0, 0, 0, 0, 0, 2)
        check(got == want and got <= 232448, f"f_weights_smem_bytes({dk}) = {got}, the "
                                             f"kernel requests {want}")
        for dtype in F32_BF16:
            f32, P = int(dtype == torch.float32), bell_bwd._planes(dtype)
            p = bell_fused.f_plan(BS, C, Co, T, H, dtype)
            check(p["smem"] <= 232448, f"F plan at BS={BS} C={C} Co={Co} T={T} H={H}: {p}")
            for tn in {p["tn"], 16}:
                for kc in {p["kc"], 16}:
                    for ocb in {p["ocb"], 16}:
                        tiles = (C, H, tn, p["nt"], kc, p["hg"], p["cc"], ocb)
                        got = (bell_fused.f_wmma_smem_bytes(P, *tiles),
                               bell_fused.f_wmma_stage_bytes(P, p["cc"], tn, p["nt"], kc,
                                                             p["hg"]))
                        want = tuple(lib.bell_fused_wmma_smem_bytes(f32, *tiles, what)
                                     for what in (0, 1))
                        check(got == want, f"F bytes at {tiles} {dtype}: {got}, the kernel "
                                           f"requests {want}")


def check_k2_smem():
    """bell_bwd.k2_smem_bytes (the Python mirror) against the bytes the
    kernel of csrc/bell_bwd.cu requests, in both dtypes, at every BELL
    shape and past the old caps, for k2_plan's tiles and the other tiles
    the kernel takes; every plan fits a block."""
    lib = bell_bwd._load()
    for BS, C, Co, T, _, _ in bell_smem_shapes():
        BSp = bell_bwd._pad16(BS)
        for dtype in F32_BF16:
            f32, P = int(dtype == torch.float32), bell_bwd._planes(dtype)
            p = bell_bwd.k2_plan(BS, C, Co, T, dtype)
            check(p["smem"] <= 232448, f"K2 plan at BS={BS} C={C} Co={Co} T={T}: {p}")
            for nt in sorted({1, p["nt"]}):
                for tr in (t for t in (16, 32, 64, 128) if BSp % t == 0):
                    for occ in sorted({p["occ"], 16}):
                        got = bell_bwd.k2_smem_bytes(P, BS, C, Co, nt, tr, occ)
                        want = lib.bell_bwd_k2_wmma_smem_bytes(f32, BS, C, Co, nt, tr, occ)
                        check(got == want, f"k2_smem_bytes({P}, BS={BS}, C={C}, Co={Co}, "
                                           f"nt={nt}, tr={tr}, occ={occ}) = {got}, the kernel "
                                           f"requests {want}")


def check_k1_smem():
    """bell_bwd.k1_smem_bytes (the Python mirror) against the bytes the
    kernels of csrc/bell_bwd.cu request, in both dtypes, at every BELL
    shape and past the old caps, for k1_plan's tiles of both passes and
    their neighbours; every plan fits a block."""
    lib = bell_bwd._load()
    for BS, C, Co, T, _, _ in bell_smem_shapes():
        for dtype in F32_BF16:
            f32, P = int(dtype == torch.float32), bell_bwd._planes(dtype)
            p = bell_bwd.k1_plan(BS, C, Co, T, dtype)
            check(max(p["smem"]) <= 232448, f"K1 plan at BS={BS} C={C} Co={Co}: {p}")
            tiles = [(0, (p["tn"], p["rs"], p["cc"], p["occ"])), (0, (16, p["rs"], 16, 16)),
                     (1, (p["tc"], p["ks"], p["ocb"], p["wo"])), (1, (16, 16, 16, 1))]
            for pass_, t in tiles:
                got = bell_bwd.k1_smem_bytes(P, BS, C, Co, t, pass_)
                want = lib.bell_bwd_k1_wmma_smem_bytes(f32, BS, C, Co, *t, pass_)
                check(got == want, f"k1_smem_bytes({P}, BS={BS}, C={C}, Co={Co}, {t}, pass "
                                   f"{pass_}) = {got}, the kernel requests {want}")


# the bf16 K1's dΘ against the plain version's float32 dΘ on the same
# operands, as max |Δ| over max |plain|: the design splits agg into bf16 hi
# + lo (float32 in value), a design without the lo term
# (k1_nosplit_dtheta) rounds agg to bf16 before the contraction
K1_SPLIT_TOL = 1e-4


def k1_nosplit_dtheta(active_src, active_tgt, thetas, gm, x, w):
    """The control of the split check: dΘ as bell_k1_plain computes it,
    with agg rounded to bf16 before its product with gm."""
    B, A, H, BS, _ = w.shape
    M = x.shape[-1]
    _, C, Co = thetas.shape
    T = M // C
    active_src, active_tgt = active_src.long(), active_tgt.long()
    x_src = x.reshape(B, -1, BS, M)[:, active_src].float()
    agg = torch.einsum("bahst,basm->bahtm", w.float(), x_src).bfloat16().float()
    gm_t = gm.float().reshape(B, -1, BS, Co, T)[:, active_tgt]
    return torch.einsum("bahvct,bavot->hco", agg.reshape(B, A, H, BS, C, T), gm_t)


# the bf16 F's output against the plain version's bf16 output on the same
# operands: the share of outputs whose bf16 value differs. The design mixes
# agg and Θ as bf16 hi + lo (float32 in value; its last bits differ from
# the plain float32 sums, so a rounding tie falls the other way on a few
# outputs), a design without the lo terms (f_nosplit_plain) rounds agg to
# bf16 before the mix and moves about a fifth of them
F_SPLIT_SHARE = 1e-2


def f_nosplit_plain(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas):
    """The control of F's split check: the forward as bell_forward_plain
    computes it, with agg rounded to bf16 before the Θ mix."""
    B, Np, M = x.shape
    H, C, Co = thetas.shape
    T = M // C
    NJ, BS = tile_start.shape[0], bias_t.shape[-1]
    a_tgt, active_src = bell_fused._tgt_of(tile_start, tile_count), active_src.long()
    _, _, att = bell_fused.active_softmax(q, k, bias_t, active_src, a_tgt, NJ)
    w = (cheb_t[None] * att).to(x.dtype)
    x_src = x.reshape(B, -1, BS, M)[:, active_src].float()
    agg = torch.zeros((B, NJ, H, BS, M), dtype=torch.float32, device=x.device)
    agg.index_add_(1, a_tgt, torch.einsum("bahst,basm->bahtm", w.float(), x_src))
    agg = agg.bfloat16().float()
    out = torch.einsum("bjhvct,hco->bjvot", agg.reshape(B, NJ, H, BS, C, T), thetas)
    return torch.relu(out).reshape(B, NJ * BS, Co * T).to(x.dtype)


def k2_control(src_start, src_count, src_order, active_tgt, thetas, gm, w, *, round_g):
    """The controls of K2's split check: dx as bell_k2_plain computes it,
    with g_agg rounded to bf16 before its product with w (``round_g``,
    the design without g's lo plane), or with Θ rounded to bf16 (without
    Θ's lo plane)."""
    if not round_g:
        return bell_bwd.bell_k2_plain(src_start, src_count, src_order, active_tgt,
                                      thetas.bfloat16().float(), gm, w)
    B, A, H, BS, _ = w.shape
    _, C, Co = thetas.shape
    T = gm.shape[-1] // Co
    NI = src_count.shape[0]
    a_src = torch.empty(A, dtype=torch.long, device=w.device)
    a_src[src_order.long()] = torch.repeat_interleave(
        torch.arange(NI, device=w.device), src_count.long())
    g = bell_bwd._g_agg(gm, thetas, T).bfloat16().float()
    g = g.reshape(B, -1, BS, H, C * T)[:, active_tgt.long()]
    dx = torch.zeros((B, NI, BS, C * T), dtype=torch.float32, device=gm.device)
    dx.index_add_(1, a_src, torch.einsum("bahst,bathm->basm", w.float(), g))
    return dx.reshape(B, NI * BS, C * T).to(gm.dtype)


def k2_split_check(k2_args, dx_k, dx_p) -> dict:
    """The share of the bf16 K2's outputs that differ from the plain
    version's, within F_SPLIT_SHARE, where both controls (g_agg or Θ
    rounded to bf16) differ on more."""
    out = {"kernel": bf16_diff(dx_k, dx_p),
           "nosplit_g": bf16_diff(k2_control(*k2_args, round_g=True), dx_p),
           "nosplit_theta": bf16_diff(k2_control(*k2_args, round_g=False), dx_p),
           "tol_share": F_SPLIT_SHARE}
    out["ok"] = (out["kernel"]["share"] <= F_SPLIT_SHARE
                 < min(out["nosplit_g"]["share"], out["nosplit_theta"]["share"]))
    return out


def bf16_diff(got, want) -> dict:
    """The share of bf16 outputs that differ, and the largest difference in
    bf16 ulps of the plain output (where it is not zero)."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    nz = w != 0
    return {"share": float((g != w).float().mean()),
            "max_ulps": float(((g - w).abs() / ulp)[nz].max()) if bool(nz.any()) else 0.0}


# (label, n, density, BS, B, H, C, T, Co, d_k): random graphs whose shapes
# take the bf16 F's and K2's other paths: Θ mixed in four output-column
# chunks and a ragged last column tile (F), one stage of 16 target rows and
# four channel groups (K2), ragged rows (C = 64, Co = 512, BS = 120); plain
# loads of x and gm (T % 8 != 0), a padded column tile (C odd), an odd head
# group (H = 3) and Co padded to 16; one head (F: a stage; K2: gm restaged
# every step); 16 source rows a stage and 21 depth steps of F's mix (H·C =
# 336, its plan's edge), six heads and a ragged channel group (K2); plain
# loads of w (BS % 8 != 0)
BELL_CORNER_SHAPES = [
    ("c64_co512_bs120", 250, 0.05, 120, 2, 2, 64, 16, 512, 32),
    ("c5_t7_h3_bs48", 100, 0.08, 48, 2, 3, 5, 7, 3, 8),
    ("h1_c32_bs32", 64, 0.1, 32, 2, 1, 32, 24, 16, 16),
    ("h6_c56_bs64", 64, 0.1, 64, 2, 6, 56, 16, 5, 32),
    ("bs20_c4_t16", 57, 0.15, 20, 2, 2, 4, 16, 8, 8),
]


def corner_rows():
    """F, K1 and K2 against their plain versions at BELL_CORNER_SHAPES in
    both dtypes: within BELL_TOL of scale, the split checks (bf16 F and K2:
    the share of outputs that differ; float32: f32_split_check), the same
    bits over two launches."""
    rows = []
    for seed, (label, n, density, BS, B, H, C, T, Co, dk) in enumerate(BELL_CORNER_SHAPES):
        bell = block_ell_from_adjacency(random_adjacency(n, density, 10 + seed),
                                        block_size=BS).to("cuda")
        t = bell.tensors
        for dtype in F32_BF16:
            z = bell_inputs(bell, B, H, C, T, Co, dk, dtype, 500 + seed)
            f_args = (t["tile_start"], t["tile_count"], t["active_src"],
                      z["q"], z["k"], z["bias"], z["cheb"], z["x"], z["thetas"])
            k1_args = (t["active_src"], t["active_tgt"], t["tile_start"], t["tile_count"],
                       z["thetas"], z["gm"], z["x"], z["w"])
            k2_args = (t["src_start"], t["src_count"], t["src_order"], t["active_tgt"],
                       z["thetas"], z["gm"], z["w"])
            k1_plain = lambda *a: bell_bwd.bell_k1_plain(*a[:2], *a[4:])
            runs = {"bell_fused": (bell_fused.bell_forward_cuda, bell_fused.bell_forward_plain,
                                   f_args, bell_fused.f_plan(BS, C, Co, T, H, dtype)),
                    "bell_k1": (bell_bwd.bell_k1_cuda, k1_plain, k1_args,
                                bell_bwd.k1_plan(BS, C, Co, T, dtype)),
                    "bell_k2": (bell_bwd.bell_k2_cuda, bell_bwd.bell_k2_plain, k2_args,
                                bell_bwd.k2_plan(BS, C, Co, T, dtype))}
            got, want = {}, {}
            for name, (kern, plain, args, plan) in runs.items():
                out_k, again = kern(*args), kern(*args)
                out_p = plain(*args)
                if name == "bell_k1":
                    (got["dA"], got["dtheta"]), (want["dA"], want["dtheta"]) = out_k, out_p
                    same = bool(torch.equal(out_k[1], again[1]))
                    errs = [rel_err(g, w) for g, w in zip(out_k, out_p)]
                    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
                else:
                    key = "out" if name == "bell_fused" else "dx"
                    got[key], want[key] = out_k, out_p
                    same = bool(torch.equal(out_k, again))
                    err, rel = rel_err(out_k, out_p)
                row = {"kernel": f"{name}_corner", "shape": label,
                       "dtype": str(dtype).split(".")[-1], "B": B, "H": H, "N": n, "BS": BS,
                       "A": bell.num_active, "S": bell.max_blocks, "C": C, "T": T, "Co": Co,
                       "d_k": dk, "plan": plan, "max_abs_err": err, "rel_err": rel,
                       "tol": BELL_TOL[dtype], "bit_identical": same}
                if dtype == torch.bfloat16 and name == "bell_fused":
                    row["split_check"] = {"kernel": bf16_diff(out_k, out_p),
                                          "nosplit": bf16_diff(f_nosplit_plain(*args), out_p)}
                elif dtype == torch.bfloat16 and name == "bell_k2":
                    row["split_check"] = k2_split_check(args, out_k, out_p)
                row["ok"] = (rel <= row["tol"] and same and (
                    "split_check" not in row
                    or row["split_check"]["kernel"]["share"] <= F_SPLIT_SHARE))
                print("bell", json.dumps(row), flush=True)
                check(row["ok"], f"the {dtype} {name} at {label}: {row}")
                rows.append(row)
            if dtype == torch.float32:
                split = f32_split_check(f_args, k1_args, k2_args, got, want)
                print("bell", json.dumps({"kernel": "f32_split_corner", "shape": label,
                                          "split_check": split}), flush=True)
                check(split["ok"], f"the float32 kernels' split check at {label}: {split}")
            del z, got, want
    return rows


def _bf16r(t):
    """t rounded to bf16, in float32."""
    return t.bfloat16().float()


def f32_nosplit_forward(tile_start, tile_count, active_src, q, k, bias_t, cheb_t, x, thetas):
    """The control of the float32 F's split check: the forward as
    bell_forward_plain computes it in float32, with every product operand
    rounded to bf16 (w and x before the SpMM, agg and Θ before the mix)."""
    B, Np, M = x.shape
    H, C, Co = thetas.shape
    T = M // C
    NJ, BS = tile_start.shape[0], bias_t.shape[-1]
    a_tgt, active_src = bell_fused._tgt_of(tile_start, tile_count), active_src.long()
    _, _, att = bell_fused.active_softmax(q, k, bias_t, active_src, a_tgt, NJ)
    w = _bf16r(cheb_t[None] * att)
    x_src = _bf16r(x).reshape(B, -1, BS, M)[:, active_src]
    agg = torch.zeros((B, NJ, H, BS, M), dtype=torch.float32, device=x.device)
    agg.index_add_(1, a_tgt, torch.einsum("bahst,basm->bahtm", w, x_src))
    out = torch.einsum("bjhvct,hco->bjvot", _bf16r(agg).reshape(B, NJ, H, BS, C, T),
                       _bf16r(thetas))
    return torch.relu(out).reshape(B, NJ * BS, Co * T)


def f32_split_check(f_args, k1_args, k2_args, got, want) -> dict:
    """The float32 kernels (split hi + lo on the tensor cores) against the
    plain float32 versions, as max |Δ| over max |plain|, in F's output, dA,
    dΘ and dx: each within SPLIT_TOL, where a no-split control (every
    product operand rounded to bf16: f32_nosplit_forward, and the plain K1
    and K2 on bf16-rounded x, w, gm and Θ) is not."""
    th, gm, x, w = k1_args[4], k1_args[5], k1_args[6], k1_args[7]
    c_dA, c_dth = bell_bwd.bell_k1_plain(*k1_args[:2], _bf16r(th), _bf16r(gm), _bf16r(x),
                                         _bf16r(w))
    c_dx = bell_bwd.bell_k2_plain(*k2_args[:4], _bf16r(th), _bf16r(gm), _bf16r(w))
    control = {"out": f32_nosplit_forward(*f_args), "dA": c_dA, "dtheta": c_dth, "dx": c_dx}
    out = {}
    for name, ctl in control.items():
        out[name] = {"kernel": rel_err(got[name], want[name])[1],
                     "nosplit": rel_err(ctl, want[name])[1]}
    out["tol"] = SPLIT_TOL
    out["ok"] = all(v["kernel"] <= SPLIT_TOL < v["nosplit"] for k, v in out.items()
                    if k != "tol")
    return out


def phase_bell_kernels():
    """F, K1 and K2 against their plain versions at every BELL shape, in f32
    and bf16, with CUDA-event times: the GAMBIA blocks, the random and
    ragged graphs, and the widths past the old caps (BELL_NEW_SHAPES); dΘ
    of two K1 launches, F's output and K2's dx of two launches must be
    equal bit for bit; the float32 kernels within SPLIT_TOL of the plain
    float32 versions in the output, dA, dΘ and dx, where a no-split control
    is not (f32_split_check); the bf16 K1's dΘ within K1_SPLIT_TOL of the
    plain float32 dΘ, which a no-split control misses; the bf16 F and K2
    differ from the plain bf16 output on at most F_SPLIT_SHARE of their
    outputs, where no-split controls differ on more, also at
    BELL_CORNER_SHAPES. Each row names its design and plan and carries the
    float32 kernel's time at its shape."""
    check_k1_smem()
    check_k2_smem()
    check_f_smem()
    rows = []
    for seed, (label, kind, B, H, C, T, Co, BS, dk) in enumerate(BELL_SHAPES):
        bell = bell_graph(kind, BS)
        t = bell.tensors
        A, Np = bell.num_active, bell.padded_nodes
        big = C * T * B * A * BS > 2e9 or C * Co >= 128 * 128
        for dtype in (torch.float32, torch.bfloat16):
            tol = BELL_TOL[dtype]
            z = bell_inputs(bell, B, H, C, T, Co, dk, dtype, seed)
            f_args = (t["tile_start"], t["tile_count"], t["active_src"],
                      z["q"], z["k"], z["bias"], z["cheb"], z["x"], z["thetas"])
            k1_args = (t["active_src"], t["active_tgt"], t["tile_start"],
                       t["tile_count"], z["thetas"], z["gm"], z["x"], z["w"])
            k2_args = (t["src_start"], t["src_count"], t["src_order"],
                       t["active_tgt"], z["thetas"], z["gm"], z["w"])
            out_k = bell_fused.bell_forward_cuda(*f_args)
            out_again = bell_fused.bell_forward_cuda(*f_args)
            dA_k, dth_k = bell_bwd.bell_k1_cuda(*k1_args)
            _, dth_again = bell_bwd.bell_k1_cuda(*k1_args)
            dx_k = bell_bwd.bell_k2_cuda(*k2_args)
            dx_again = bell_bwd.bell_k2_cuda(*k2_args)
            torch.cuda.synchronize()
            out_p = bell_fused.bell_forward_plain(*f_args)
            dA_p, dth_p = bell_bwd.bell_k1_plain(*k1_args[:2], *k1_args[4:])
            dx_p = bell_bwd.bell_k2_plain(*k2_args)
            errs = {"bell_fused": [rel_err(out_k, out_p)],
                    "bell_k1": [rel_err(dA_k, dA_p), rel_err(dth_k, dth_p)],
                    "bell_k2": [rel_err(dx_k, dx_p)]}
            split = f_split = k2_split = f32_split = None
            if dtype == torch.bfloat16:
                k2_split = k2_split_check(k2_args, dx_k, dx_p)
                ctl = f_nosplit_plain(*f_args)
                f_split = {"kernel": bf16_diff(out_k, out_p), "nosplit": bf16_diff(ctl, out_p),
                           "tol_share": F_SPLIT_SHARE}
                f_split["ok"] = (f_split["kernel"]["share"] <= F_SPLIT_SHARE
                                 < f_split["nosplit"]["share"])
                scale = float(dth_p.abs().max())
                ctl = k1_nosplit_dtheta(*k1_args[:2], *k1_args[4:])
                split = {"dtheta_rel_err": float((dth_k - dth_p).abs().max()) / scale,
                         "nosplit_rel_err": float((ctl - dth_p).abs().max()) / scale,
                         "tol": K1_SPLIT_TOL}
                split["ok"] = split["dtheta_rel_err"] <= K1_SPLIT_TOL < split["nosplit_rel_err"]
                del ctl
            else:
                f32_split = f32_split_check(
                    f_args, k1_args, k2_args,
                    {"out": out_k, "dA": dA_k, "dtheta": dth_k, "dx": dx_k},
                    {"out": out_p, "dA": dA_p, "dtheta": dth_p, "dx": dx_p})
            del out_p, dA_p, dth_p, dx_p
            bounds = bell_bounds(B, H, A, BS, dk, C, T, Co, Np, dtype)
            iters = 3 if big else 5 if Np > 1024 else 20
            fns = {"bell_fused": (lambda: bell_fused.bell_forward_cuda(*f_args),
                                  lambda: bell_fused.bell_forward_plain(*f_args)),
                   "bell_k1": (lambda: bell_bwd.bell_k1_cuda(*k1_args),
                               lambda: bell_bwd.bell_k1_plain(*k1_args[:2], *k1_args[4:])),
                   "bell_k2": (lambda: bell_bwd.bell_k2_cuda(*k2_args),
                               lambda: bell_bwd.bell_k2_plain(*k2_args))}
            plans = {"bell_fused": bell_fused.f_plan(BS, C, Co, T, H, dtype),
                     "bell_k1": bell_bwd.k1_plan(BS, C, Co, T, dtype),
                     "bell_k2": bell_bwd.k2_plan(BS, C, Co, T, dtype)}
            plans["bell_k1"]["time_groups"] = bell_bwd.k1_time_groups(
                B, bell.num_tiles, BS, H, C, Co, T)
            for name, (kern, plain) in fns.items():
                row = {"kernel": name, "shape": label, "dtype": str(dtype).split(".")[-1],
                       "B": B, "H": H, "N": bell.n_nodes, "BS": BS, "A": A,
                       "S": bell.max_blocks, "C": C, "T": T, "Co": Co, "d_k": dk,
                       "max_abs_err": max(e[0] for e in errs[name]),
                       "rel_err": max(e[1] for e in errs[name]), "tol": tol,
                       "plan": plans[name]}
                row["ok"] = row["rel_err"] <= tol
                if name == "bell_k1":
                    row["dtheta_bit_identical"] = bool(torch.equal(dth_k, dth_again))
                    if split is not None:
                        row["split_check"] = split
                if name == "bell_fused":
                    row["out_bit_identical"] = bool(torch.equal(out_k, out_again))
                    if f_split is not None:
                        row["split_check"] = f_split
                if name == "bell_k2":
                    row["dx_bit_identical"] = bool(torch.equal(dx_k, dx_again))
                    if k2_split is not None:
                        row["split_check"] = k2_split
                if f32_split is not None:
                    row["split_check"] = f32_split
                row["ms"] = cuda_ms(kern, iters)
                row["plain_ms"] = cuda_ms(plain, max(1, iters // 4))
                row["bound_ms"], row["bound_by"], row["flops"] = bounds[name]
                row["design"] = bell_design(name, dtype)
                f32 = [r for r in rows if r["kernel"] == name and r["shape"] == label
                       and r["dtype"] == "float32"]
                row["f32_ms"] = row["ms"] if dtype == torch.float32 else f32[0]["ms"]
                print("bell", json.dumps(row), flush=True)
                check(row["ok"], f"{name} vs plain at {label} {dtype}: "
                                 f"{row['rel_err']:.3g} > {tol}")
                check(name != "bell_k1" or split is None or split["ok"],
                      f"the bf16 K1's dΘ split check at {label}: {split}")
                check(name != "bell_fused" or f_split is None or f_split["ok"],
                      f"the bf16 F's split check at {label}: {f_split}")
                check(name != "bell_k2" or k2_split is None or k2_split["ok"],
                      f"the bf16 K2's split check at {label}: {k2_split}")
                check(f32_split is None or f32_split["ok"],
                      f"the float32 kernels' split check at {label}: {f32_split}")
                check(row.get("dx_bit_identical", True),
                      f"K2's dx differs between two launches at {label} {dtype}")
                check(row.get("out_bit_identical", True),
                      f"F's output differs between two launches at {label} {dtype}")
                check(row.get("dtheta_bit_identical", True),
                      f"K1 dΘ differs between two launches at {label} {dtype}")
                rows.append(row)
            del z, out_k, out_again, dA_k, dth_k, dth_again, dx_k, dx_again
            torch.cuda.empty_cache()
    return rows + corner_rows()


# ---------------------------------------------------------------------------
# phase 2c: the fused dense kernels (TAt, spatial middle) vs their plain versions
# ---------------------------------------------------------------------------

F32_BF16 = (torch.float32, torch.bfloat16)
TAT_SHAPES = [
    # (label, B·F, T, N, H, d_k, d_v, embed, dtypes): PEMS08 block 1 (F=1)
    # and blocks 2-4 (F=32) at B=64, the embedding mode at block 1, a ragged
    # shape, and two that a float32 row in one block could not hold: PEMS07's
    # N = 883 at blocks 2-4 with its batch of 12, and GAMBIA's block 2 (T =
    # 144, N = 2139, H = 2, d_k = d_v = 32, B = 4, F = 32; bench.py:222-236);
    # then the shapes the whole-row passes refused, at PEMS08 widths: N =
    # 4096 and LargeST California's 8600 at T = 12 (N in column chunks;
    # blocks 2-4 of the large-N CLI phase, B = 16, and its block 1 with the
    # embedding), and T = 576 and 1024 at N = 170 (query tiles and key
    # chunks; blocks 2-4 of the long-T CLI phase, B = 8, its block 1 with
    # the embedding, and T = 1024 at B = 2)
    ("pems08_block1", 64, 12, 170, 3, 32, 32, False, F32_BF16),
    ("pems08_blocks2-4", 2048, 12, 170, 3, 32, 32, False, F32_BF16),
    ("pems08_block1_embed", 64, 12, 170, 3, 32, 32, True, F32_BF16),
    ("ragged_n29", 5, 7, 29, 2, 8, 8, False, F32_BF16),
    ("pems07_n883", 384, 12, 883, 3, 32, 32, False, F32_BF16),
    ("gambia_t144", 128, 144, 2139, 2, 32, 32, False, F32_BF16),
    ("n4096_t12", 512, 12, 4096, 3, 32, 32, False, F32_BF16),
    ("n8600_t12", 512, 12, 8600, 3, 32, 32, False, F32_BF16),
    ("n8600_t12_embed", 16, 12, 8600, 3, 32, 32, True, F32_BF16),
    ("t576_n170", 256, 576, 170, 3, 32, 32, False, F32_BF16),
    ("t576_n170_embed", 8, 576, 170, 3, 32, 32, True, F32_BF16),
    ("t1024_n170", 64, 1024, 170, 3, 32, 32, False, F32_BF16),
]
# the head widths the passes take since they chunk the heads: the blocks of
# the wide_heads CLI project (GAMBIA, N = 2139, batch 4, F = 4 then 32, T =
# 144 then 12, 8 heads of d_k = d_v = 128; block 1 also with the
# embedding, whose g_te pass then splits g_qkv; time_strides 1, so block 2
# is at T = 144 too) and of the wide_channels project (PEMS08 width, N =
# 170, T = 12, batch 8, F = 1 then 512, 8 heads of 128), d_k = d_v = 256 at T = 48 (the attention backward streamed), 512
# at T = 48 (both attention passes on the chunked route) and H·d_v = 4096
# (8 heads of 512: the out, LN1-backward and g_te passes split)
TAT_WIDE_SHAPES = [
    ("wide_heads_block1", 16, 144, 2139, 8, 128, 128, False, F32_BF16),
    ("wide_heads_block1_embed", 16, 144, 2139, 8, 128, 128, True, F32_BF16),
    ("wide_heads_block2", 128, 144, 2139, 8, 128, 128, False, F32_BF16),
    ("wide_channels_block1", 8, 12, 170, 8, 128, 128, False, F32_BF16),
    ("wide_channels_blocks2-4", 4096, 12, 170, 8, 128, 128, False, F32_BF16),
    ("dk256_t48", 64, 48, 170, 2, 256, 256, False, F32_BF16),
    ("dk512_t48", 32, 48, 170, 2, 512, 512, False, F32_BF16),
    ("hv4096_t12", 64, 12, 170, 8, 512, 512, False, F32_BF16),
]
# the TAt shapes past the whole-row passes' caps (PERF.md's sub-table)
TAT_NEW_SHAPES = ("n4096_t12", "n8600_t12", "n8600_t12_embed", "t576_n170",
                  "t576_n170_embed", "t1024_n170")
SPATIAL_SHAPES = [
    # (label, B, N, F, T, C, Co, d, K, d_k, dtypes): PEMS08 block 1 and
    # blocks 2-4, a ragged shape (N, F·T, C·T and d multiples of no tile),
    # PEMS07's N = 883 at the same widths with the reference's PEMS07 batch
    # of 12 (BASELINE.md), a ragged N = 1001 (no tile of 16 or 64 divides
    # it), GAMBIA's blocks 1 and 2 (N = 2139, T = 144: time chunks of 72 and
    # of 12 steps; d = 64, K = 2, B = 4), and a d wide enough that the bf16
    # embedding pass takes 16 rows a block, not 32
    ("pems08_block1", 64, 170, 1, 12, 1, 32, 512, 3, 32, F32_BF16),
    ("pems08_blocks2-4", 64, 170, 32, 12, 32, 32, 512, 3, 32, F32_BF16),
    ("ragged_n29", 3, 29, 2, 7, 3, 5, 24, 2, 8, F32_BF16),
    ("pems07_blocks2-4", 12, 883, 32, 12, 32, 32, 512, 3, 32, F32_BF16),
    ("ragged_n1001", 2, 1001, 32, 12, 32, 32, 512, 3, 32, F32_BF16),
    ("gambia_block1", 4, 2139, 4, 144, 4, 32, 64, 2, 32, F32_BF16),
    ("gambia_block2", 4, 2139, 32, 144, 32, 32, 64, 2, 32, F32_BF16),
    ("wide_d2048", 2, 20, 1, 12, 1, 8, 2048, 2, 8, F32_BF16),
]
# the widths the kernels take since they chunk C, Co, d and the SAt's d_k:
# the blocks of the wide_heads CLI project (GAMBIA at d_k = 128) and of the
# wide_channels project (PEMS08 width with C = Co = 512 and d = 4096: C and
# Co in chunks of 256, the embedding passes in chunks of d; batch 8), and
# d_k = 512 at PEMS08 blocks 2-4 (the score passes take d_k in chunks of 128)
SPATIAL_WIDE_SHAPES = [
    ("wide_heads_block1", 4, 2139, 4, 144, 4, 32, 64, 2, 128, F32_BF16),
    ("wide_heads_block2", 4, 2139, 32, 144, 32, 32, 64, 2, 128, F32_BF16),
    ("wide_channels_block1", 8, 170, 1, 12, 1, 512, 4096, 3, 128, F32_BF16),
    ("wide_channels_blocks2-4", 8, 170, 512, 12, 512, 512, 4096, 3, 128, F32_BF16),
    ("sat_dk512", 8, 170, 32, 12, 32, 32, 512, 3, 512, F32_BF16),
]

SPATIAL_KEEP = 0.95  # the model's dropout rate 0.05: the main path's mask
SPATIAL_DIFF = (0, 1, 3, 4, 5, 6, 7, 8, 9, 11)  # not the mask, not the Chebyshev planes
FUSED_TOL = {torch.float32: (TOL, GRAD_TOL),
             # bf16: ~2.5 ulps of 2^-8 of the output's scale (BELL_TOL)
             torch.bfloat16: (1e-2, 1e-2)}


def _bound(ops, nbytes, dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops


def tat_bounds(BF, T, N, H, dk, dv, dtype):
    """(bound_ms, bound_by, flops) of the TAt forward and backward from the
    function's own traffic: x, res (and the cotangents) read once, out,
    scores (dx, dres and the float32 weight gradients) written once,
    weights and LN vectors read once. Both dtypes run the split passes:
    each product counts its bf16 terms at 989 TFLOP/s (bfloat16: qkv =
    x·wqkv one, both operands bf16; the out-projection, g_ctx, g_te and
    dwqkv two, one float32 operand split; dwo three; float32: every
    product three, x and the weights split too), the attention and
    LayerNorm arithmetic at 67 TFLOP/s, the larger of the two times. The
    rows also carry ``design_ms``: the same bound with the bytes of the
    passes' own float32 intermediates added (qkv, ctx; backward also
    g_ypre, g_ctx, g_qkv, each written once and read once by every pass
    that consumes it), which the function does not need."""
    W, hv, M = H * (2 * dk + dv), H * dv, BF * T
    att_f = 2 * BF * H * T * T * (dk + dv)
    att_b = 2 * BF * H * T * T * (2 * dv + 2 * dk)
    qkv_f, out_f = 2 * M * N * W, 2 * M * hv * N
    ln_f, ln_b = 8 * M * N, 22 * M * N  # LN1 forward; its backward with the recompute
    f32 = dtype != torch.bfloat16
    terms = (3, 3, 3, 3, 3, 3) if f32 else (1, 2, 2, 2, 2, 3)
    fwd_mma = terms[0] * qkv_f + terms[1] * out_f
    bwd_mma = terms[0] * qkv_f + terms[1] * out_f + terms[2] * (2 * M * N * hv) \
        + terms[3] * (2 * M * W * N) + terms[4] * (2 * M * N * W) + terms[5] * (2 * M * hv * N)
    xb = 4 if f32 else 2
    act = BF * (T * N + H * T * T) * xb
    weights = (N * W + hv * N) * xb + 4 * N * xb
    grads = 4 * (N * W + hv * N + 4 * N)
    inter_f = 4 * M * (2 * W + 2 * hv)  # qkv and ctx, written and read
    # qkv (written, read twice), ctx (written, read by LN1 backward and dwo),
    # g_ypre (written, read by g_te and dwo), g_ctx (written, read), g_qkv
    # (written, read by g_te and dwqkv)
    inter_b = 4 * M * (3 * W + 3 * hv + 3 * N + 2 * hv + 3 * W)

    def bound(mma, other, nbytes, design_bytes):
        # the tensor cores and the CUDA cores may overlap
        t_ops = max(mma / PEAK_BF16_FLOPS, other / PEAK_F32_FLOPS)
        t_bytes = nbytes / PEAK_HBM_BYTES
        return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                mma + other, max(t_ops, (nbytes + design_bytes) / PEAK_HBM_BYTES) * 1e3)

    return {"tat_fwd": bound(fwd_mma, att_f + ln_f, 2 * act + weights, inter_f),
            "tat_bwd": bound(bwd_mma, att_f + att_b + ln_b, 3 * act + weights + grads, inter_b)}


def spatial_bounds(B, N, F, T, C, Co, d, K, dk, dtype):
    """(bound_ms, bound_by, flops) of the spatial forward and backward:
    the N²·C·T products (agg, dA, dxm) on the tensor cores, one bf16 term
    each in bfloat16 and three (hi/lo split) in float32, at 989 TFLOP/s;
    the rest (embedding, scores, softmax, Θ mix, dk, dq) at the dtype's
    rate (bf16 989, float32 67 TFLOP/s), the larger of the two times (the
    tensor cores and the CUDA cores may overlap); bytes: tat, xm, the mask, the weights
    and the (K, N, N) bias and Chebyshev planes read once, out (dtat, dxm
    and the float32 weight gradients) written once."""
    FT, CT, xb, hk2 = F * T, C * T, (2 if dtype == torch.bfloat16 else 4), 2 * K * dk
    terms = 1 if dtype == torch.bfloat16 else 3
    mma_f = B * K * 2 * N * N * CT
    rest_f = B * (2 * N * FT * d + 2 * N * d * hk2 + K * (2 * N * N * dk + 2 * N * CT * Co))
    mma_b = mma_f + B * K * 4 * N * N * CT
    rest_b = rest_f + B * (K * (4 * N * CT * Co + 4 * N * N * dk) + 4 * N * d * hk2
                           + 4 * N * FT * d)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    acts = B * N * (FT + CT + d) * xb
    weights = (FT * d + hk2 * d + 3 * d + N * d + 2 * K * N * N + K * C * Co) * xb
    grads = 4 * (FT * d + 3 * d + N * d + d * hk2 + K * N * N + K * C * Co)
    out = B * N * Co * T * xb

    def bound(mma, rest, nbytes):
        # the tensor cores and the CUDA cores may overlap
        t_ops = max(terms * mma / PEAK_BF16_FLOPS, rest / peak)
        t_bytes = nbytes / PEAK_HBM_BYTES
        return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                terms * mma + rest)

    return {"spatial_fwd": bound(mma_f, rest_f, acts + weights + out),
            "spatial_bwd": bound(mma_b, rest_b, acts + weights + out + acts + grads)}


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device="cuda") * scale


def tat_inputs(BF, T, N, H, dk, dv, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = H * (2 * dk + dv)
    ins = [_randn(g, BF, T, N), _randn(g, T, N, scale=0.3), 1 + _randn(g, N, scale=0.1),
           _randn(g, N, scale=0.1), _randn(g, N, W, scale=N ** -0.5),
           _randn(g, H * dv, N, scale=(H * dv) ** -0.5), 1 + _randn(g, N, scale=0.1),
           _randn(g, N, scale=0.1), _randn(g, BF, H, T, T, scale=0.5)]
    cots = [_randn(g, BF, T, N), _randn(g, BF, H, T, T, scale=0.1)]
    return [t.to(dtype).contiguous() for t in ins], [t.to(dtype) for t in cots]


def spatial_inputs(B, N, F, T, C, Co, d, K, dk, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    FT, CT = F * T, C * T
    mask = (torch.rand(B, N, d, generator=g, device="cuda") < SPATIAL_KEEP).to(dtype)
    cheb = _randn(g, K, N, N, scale=N ** -0.5)
    ins = [_randn(g, B, N, FT), _randn(g, B, N, CT), mask, _randn(g, FT, d, scale=FT ** -0.5),
           _randn(g, d, scale=0.1), _randn(g, N, d, scale=0.3), 1 + _randn(g, d, scale=0.1),
           _randn(g, d, scale=0.1), _randn(g, d, 2 * K * dk, scale=d ** -0.5),
           _randn(g, K, N, N), cheb, _randn(g, K, C, Co, scale=C ** -0.5)]
    ins = [t.to(dtype).contiguous() for t in ins]
    return ins, [_randn(g, B, N, Co * T).to(dtype)]


def _grad_run(fn, ins, cots, diff):
    """Outputs and the gradients of the inputs at ``diff`` under the
    cotangents ``cots``."""
    leaves = [t.detach().clone().requires_grad_(i in diff) for i, t in enumerate(ins)]
    outs = fn(leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    inputs = [leaves[i] for i in diff]
    # without the embedding the plain TAt does not read pos or LN0: zeros
    grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    return [o.detach() for o in outs], grads


def away_from_kink(kern, plain, ins, cots, tol):
    """The cotangent with zeros where either side's ReLU output lies in
    (0, tol·scale]: there the pre-activation is within rounding of the kink,
    and the two sides' masks may differ (one element flipped changes a whole
    batch row's gradients)."""
    with torch.no_grad():
        outs = [kern(ins).float(), plain(ins).float()]
    scale = max(1.0, float(outs[1].abs().max()))
    near = torch.zeros_like(outs[0], dtype=torch.bool)
    for o in outs:
        near |= (o > 0) & (o <= tol * scale)
    return [cots[0].masked_fill(near, 0)]


def _compare(kernel, plain):
    """max |Δ| and max |Δ| over max(1, max |plain|), worst over the pairs."""
    errs = [rel_err(k, p) for k, p in zip(kernel, plain)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _time_backward(fn, ins, cots, diff, iters):
    leaves = [t.detach().clone().requires_grad_(i in diff) for i, t in enumerate(ins)]
    outs = fn(leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    inputs = [leaves[i] for i in diff]
    return cuda_ms(lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True,
                                               allow_unused=True), iters)


def spatial_design(dtype) -> str:
    """The arithmetic of the spatial kernels: the N²·C·T products (agg, dA,
    dxm) on the tensor cores (WMMA), one bf16 product each in bfloat16,
    three in float32 (hi/lo split); the embedding pass on the tensor cores
    in bf16 (sp_embed_wmma_kernel), on the CUDA cores in float32."""
    return "wmma_bf16" if dtype == torch.bfloat16 else "wmma_f32_split"


def check_spatial_smem():
    """block_spatial_fused.smem_bytes (the Python gate) against the bytes
    each kernel of csrc/block_spatial_fused.cu requests, and chunk_layout
    against the kernels' spatial_fused_chunks, in both dtypes, at every
    spatial shape and at PEMS08 and GAMBIA widths from N = 816 to 8192
    (the old N caps' edges 816/817 and 944/945 among them)."""
    lib = block_spatial_fused._load()
    shapes = {s[2:10] for s in SPATIAL_SHAPES + SPATIAL_WIDE_SHAPES} | {
        (N, 32, 12, 32, 32, 512, 3, 32) for N in (816, 817, 944, 945, 8192)} | {
        (N, 32, 144, 32, 32, 64, 2, 32) for N in (883, 8192)} | {
        # the edges of the chunks: C and Co at 384/385 and 768/769, d where
        # SA and SD split, d_k where the score passes chunk it
        (170, F, 12, F, Co, 512, 3, 32) for F in (384, 385, 769) for Co in (32, 384, 385)} | {
        (170, 32, 12, 32, 32, d, 3, dk) for d in (3500, 3504, 3505, 4096) for dk in (32, 256)} | {
        (170, 32, 12, 32, 32, 512, 3, dk) for dk in (500, 511, 512, 1024, 1030)}
    out = (ctypes.c_int * 6)()
    for N, F, T, C, Co, d, K, dk in sorted(shapes):
        lib.spatial_fused_chunks(N, C, T, Co, out)
        want = (*block_spatial_fused.chunk_layout(N, C, T, Co),
                block_spatial_fused.channel_chunks(C)[0], block_spatial_fused.channel_chunks(Co)[0])
        check(tuple(out) == want,
              f"spatial chunk_layout at N={N} C={C} T={T} Co={Co} = {want}, the kernels' "
              f"{tuple(out)}")
        for dtype in F32_BF16:
            got = block_spatial_fused.smem_bytes(N, F * T, C, T, Co, d, K, dk, dtype)
            for i, kernel in enumerate(block_spatial_fused.KERNELS):
                want = lib.spatial_fused_smem_bytes(N, F * T, C, T, Co, d, K, dk, i,
                                                    int(dtype == torch.bfloat16))
                check(got[kernel] == want,
                      f"spatial smem_bytes[{kernel}] at N={N} F·T={F * T} C·T={C * T} {dtype} "
                      f"= {got[kernel]}, the kernel requests {want}")


def tat_design(dtype) -> str:
    """The arithmetic of the TAt kernels, one design in both dtypes: passes
    over all B·F·T rows, their products on the tensor cores with every
    float32 operand split into two bf16 terms (WMMA; in float32 x and the
    weights too), the attention on the CUDA cores."""
    return "wmma_bf16_split" if dtype == torch.bfloat16 else "wmma_f32_split"


def check_tat_smem():
    """tat_fused's gate (``passes``, ``smem_bytes``) against the bytes each
    pass of csrc/tat_fused.cu requests, in both dtypes, at every TAt shape
    (with and without the embedding), at the edges of the caps the passes
    had before they streamed N and T (N = 3328/3329, T = 341/342 at PEMS08
    widths) and at the column chunks' edges (N = 1024/1025, one chunk and
    two)."""
    lib = tat_fused._load()
    shapes = {s[2:7] for s in TAT_SHAPES + TAT_WIDE_SHAPES} | {(12, 3328, 3, 32, 32), (12, 3329, 3, 32, 32),
                                             (341, 170, 3, 32, 32), (342, 170, 3, 32, 32),
                                             (12, 1024, 3, 32, 32), (12, 1025, 3, 32, 32)} | {
        # the routes' and splits' edges: the one-tile and streamed attention
        # at T = 144/160/161 and d_k from 96 to 1000, H·d_v past 9 tiles a
        # warp, the split passes at H·d_v and W past a block
        (T, N, H, dk, dv) for T in (48, 144, 160, 161) for N in (170, 2139)
        for H, dk, dv in ((8, 128, 128), (2, 256, 256), (1, 300, 96), (2, 1000, 1000),
                          (37, 32, 32), (8, 512, 512))}
    for T, N, H, dk, dv in sorted(shapes):
        for embed in (False, True):
            for dtype in F32_BF16:
                got = tat_fused.passes(T, N, H, dk, dv, embed, dtype)
                for i, name in enumerate(tat_fused.PASSES):
                    want = lib.tat_fused_smem_bytes(T, N, H, dk, dv, int(embed), i,
                                                    int(dtype == torch.float32))
                    check(got[name][1] == want,
                          f"tat passes[{name}] at T={T} N={N} embed={embed} {dtype} = "
                          f"{got[name][1]}, the kernel requests {want}")


# the float32 TAt and spatial passes' outputs against the plain float32
# version, forward and every gradient, as max |Δ| over max(1, max |plain|):
# the split design (every tensor-core product three bf16 terms) must stay
# within SPLIT_TOL where a design without the lo terms (tat_nosplit_plain,
# spatial_nosplit_plain) must not, or the check could not tell the two apart
SPLIT_TOL = 1e-4
# the spatial forward control's error falls with N (A's rounding averages
# over the N sources: 2.2e-4 of scale at N = 883, 1.2e-4 at 2139 on the
# H100), so its limit sits lower, between that and the kernel's worst
# reading in either direction (1.1e-5)
SPATIAL_SPLIT_TOL = 3e-5


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose cotangent is rounded to bf16: the product that
    made its input then takes the cotangent's hi term only."""

    @staticmethod
    def forward(ctx, y):
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g.bfloat16().float()


class _RoundValue(torch.autograd.Function):
    """bf16 rounding of a float32 operand (its hi term only), its cotangent
    passed through."""

    @staticmethod
    def forward(ctx, y):
        return y.bfloat16().float()

    @staticmethod
    def backward(ctx, g):
        return g


def tat_nosplit_plain(x, pos, g0, b0, wqkv, wo, g1, b1, res, *, n_heads, d_k, d_v, embed):
    """The control of the split check: the TAt function in float32 as a
    design without the lo terms computes it, every float32 operand of a
    product (te, the weights, ctx; backward g_qkv, g_ypre) rounded to bf16
    and the attention and LayerNorms kept float32. Gradients from
    autograd."""
    BF, T, N = x.shape
    r = _RoundValue.apply
    te = tat_fused._ln_hat(x + pos) * g0 + b0 if embed else x
    qkv = _RoundCotangent.apply(r(te) @ r(wqkv))
    hk = n_heads * d_k
    q = qkv[..., :hk].reshape(BF, T, n_heads, d_k)
    k = qkv[..., hk:2 * hk].reshape(BF, T, n_heads, d_k)
    v = qkv[..., 2 * hk:].reshape(BF, T, n_heads, d_v)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) * (1.0 / d_k ** 0.5) + res
    ctx = torch.einsum("rhqk,rkhd->rqhd", torch.softmax(s, dim=2), v).reshape(BF, T, -1)
    z = _RoundCotangent.apply(r(ctx) @ r(wo))
    return tat_fused._ln_hat(z + te) * g1 + b1, s


class _NoSplitAgg(torch.autograd.Function):
    """agg = Aᵀ·xm (A (B, N, N), xm (B, N, M)) as a design without the lo
    terms computes it: with ``fwd`` the forward's operands rounded to bf16,
    with ``bwd`` the backward's (dA = xm·gᵀ, dxm = A·g), float32 sums."""

    @staticmethod
    def forward(ctx, A, xm, fwd, bwd):
        ctx.save_for_backward(A, xm)
        ctx.bwd = bwd
        r = (lambda t: t.bfloat16().float()) if fwd else (lambda t: t)
        return r(A).transpose(1, 2) @ r(xm)

    @staticmethod
    def backward(ctx, g):
        A, xm = ctx.saved_tensors
        r = (lambda t: t.bfloat16().float()) if ctx.bwd else (lambda t: t)
        return r(xm) @ r(g).transpose(1, 2), r(A) @ r(g), None, None


def spatial_nosplit_plain(tat, xm, dmask, pw, pb, pos, gs, bs, wqk, bias, cheb, thetas, *,
                          K, d_k, keep, fwd, bwd):
    """The controls of the spatial split check: the spatial middle in
    float32 as a design without the lo terms computes it, the operands of
    its N²·C·T products rounded to bf16 (``fwd``: agg = Aᵀ·xm; ``bwd``:
    dA = xm·daggᵀ and dxm = A·dagg) and the rest kept float32. The
    backward's control keeps the forward exact, so its ReLU mask is the
    plain version's. Gradients from autograd."""
    B, N, _ = tat.shape
    _, C, Co = thetas.shape
    T = xm.shape[-1] // C
    z = tat @ pw + pb + pos
    mu = z.mean(dim=-1, keepdim=True)
    var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
    semx = ((z - mu) * torch.rsqrt(var + block_spatial_fused._EPS) * gs + bs) * dmask / keep
    qk = semx @ wqk
    hk = K * d_k
    out = None
    for k in range(K):
        q = qk[..., k * d_k:(k + 1) * d_k]
        kk = qk[..., hk + k * d_k:hk + (k + 1) * d_k]
        s = q @ kk.transpose(1, 2) * (1.0 / d_k ** 0.5) + bias[k]
        A = cheb[k] * torch.softmax(s, dim=1)
        agg = _NoSplitAgg.apply(A, xm, fwd, bwd).reshape(B, N, C, T)
        o = torch.einsum("bjct,co->bjot", agg, thetas[k]).reshape(B, N, Co * T)
        out = o if out is None else out + o
    return torch.relu(out)


def split_check(fwd_control, bwd_control, ins, cots, diff, fwd_err, bwd_err, outs_p,
                grads_p, tol=SPLIT_TOL):
    """The float32 passes against the plain float32 version (``fwd_err``,
    ``bwd_err``: the row's own comparison, rel. |Δ|) and the no-split
    controls against the same plain outputs ``outs_p`` (``fwd_control``)
    and gradients ``grads_p`` of the inputs at ``diff`` (``bwd_control``;
    :func:`tat_nosplit_plain` is both, :func:`spatial_nosplit_plain` one
    of each): the design must stay within ``tol`` and each control must
    not."""
    outs_c, grads_c = _grad_run(fwd_control, ins, cots, diff)
    if bwd_control is not fwd_control:
        _, grads_c = _grad_run(bwd_control, ins, cots, diff)
    ctl_f = _compare(outs_c, outs_p)
    ctl_b = _compare(grads_c, grads_p)
    return {"fwd_rel_err": fwd_err, "bwd_rel_err": bwd_err, "tol": tol,
            "nosplit_fwd_rel_err": ctl_f[1], "nosplit_bwd_rel_err": ctl_b[1],
            "ok": max(fwd_err, bwd_err) <= tol < min(ctl_f[1], ctl_b[1])}


def phase_fused_kernels():
    """The TAt and spatial-middle kernels against their plain versions at
    every shape and dtype: forward outputs and every gradient through the
    autograd Functions, every weight gradient equal bit for bit over two
    backward launches, CUDA-event times of each kernel (the TAt kernels of
    each design on their own operands, the spatial ones on float32 operands
    and the backward on the forward's ReLU mask) and of the plain version.
    Each row names its design and carries the float32 kernel's time at its
    shape; each float32 row also holds the split design against a no-split
    control (``split_check``)."""
    check_spatial_smem()
    check_tat_smem()
    rows = []
    tat_diff = tuple(range(9))
    shapes = [(seed, s, True) for seed, s in enumerate(TAT_SHAPES + TAT_WIDE_SHAPES)] + [
        (4 + seed, s, False) for seed, s in enumerate(SPATIAL_SHAPES + SPATIAL_WIDE_SHAPES)]
    for seed, shape, is_tat in shapes:
        label = shape[0]
        for dtype in shape[-1]:
            tol, gtol = FUSED_TOL[dtype]
            split = None
            if is_tat:
                _, BF, T, N, H, dk, dv, embed, _ = shape
                dims = dict(n_heads=H, d_k=dk, d_v=dv, embed=embed)
                ins, cots = tat_inputs(BF, T, N, H, dk, dv, dtype, seed)
                kern = lambda a, dims=dims: tat_fused.TatFused.apply(*a, *dims.values())
                plain = lambda a, dims=dims: tat_fused.tat_fused_plain(*a, **dims)
                diff, names = tat_diff, ("tat_fwd", "tat_bwd")
                ops, gs = tat_fused._operands(*ins), tat_fused._operands(*cots)
                fwd = lambda ops=ops, dims=dims: tat_fused.tat_forward_cuda(*ops, **dims)
                bwd = lambda ops=ops, gs=gs, dims=dims: tat_fused.tat_backward_cuda(
                    *ops, *gs, **dims)
                weight_slice = slice(2, 9)  # dpos, dg0, db0, dwqkv, dwo, dg1, db1
                bounds = tat_bounds(BF, T, N, H, dk, dv, dtype)
                desc = {"BF": BF, "T": T, "N": N, "H": H, "d_k": dk, "embed": embed}
            else:
                _, B, N, F, T, C, Co, d, K, dk, _ = shape
                dims = dict(K=K, d_k=dk, keep=SPATIAL_KEEP)
                ins, cots = spatial_inputs(B, N, F, T, C, Co, d, K, dk, dtype, seed)
                kern = lambda a, dims=dims: block_spatial_fused.SpatialMiddle.apply(
                    *a, *dims.values())
                plain = lambda a, dims=dims: block_spatial_fused.spatial_middle_plain(
                    *a, **dims)
                diff, names = SPATIAL_DIFF, ("spatial_fwd", "spatial_bwd")
                ops = block_spatial_fused._kernel_operands(*ins)
                kd = dict(dims, bf16=dtype == torch.bfloat16)
                fwd = lambda ops=ops, kd=kd: block_spatial_fused.spatial_forward_cuda(*ops, **kd)
                g32 = cots[0].float().contiguous()
                relu_mask = fwd() > 0  # the record SpatialMiddle keeps
                bwd = lambda ops=ops, g32=g32, m=relu_mask, kd=kd: (
                    block_spatial_fused.spatial_backward_cuda(*ops, g32, m, **kd))
                weight_slice = slice(2, 10)  # dpw, dpb, dpos, dgs, dbs, dwqk, dbias, dΘ
                bounds = spatial_bounds(B, N, F, T, C, Co, d, K, dk, dtype)
                desc = {"B": B, "N": N, "F": F, "T": T, "C": C, "Co": Co, "d": d, "K": K,
                        "d_k": dk}
            if not is_tat:
                cots = away_from_kink(kern, plain, ins, cots, tol)
            outs_k, grads_k = _grad_run(kern, ins, cots, diff)
            outs_p, grads_p = _grad_run(plain, ins, cots, diff)
            torch.cuda.synchronize()
            fwd_err = _compare(outs_k, outs_p)
            bwd_err = _compare(grads_k, grads_p)
            per_grad = [rel_err(k, p)[1] for k, p in zip(grads_k, grads_p)]
            if dtype == torch.float32:
                if is_tat:
                    controls = (lambda a, dims=dims: tat_nosplit_plain(*a, **dims),) * 2
                else:
                    controls = [lambda a, dims=dims, f=f: spatial_nosplit_plain(
                        *a, **dims, fwd=f, bwd=not f) for f in (True, False)]
                split = split_check(*controls, ins, cots, diff, fwd_err[1], bwd_err[1],
                                    outs_p, grads_p,
                                    tol=SPLIT_TOL if is_tat else SPATIAL_SPLIT_TOL)
            first, again = bwd(), bwd()
            torch.cuda.synchronize()
            identical = all(torch.equal(a, b) for a, b in zip(first[weight_slice],
                                                              again[weight_slice]))
            del outs_k, grads_k, outs_p, grads_p, first, again
            big = ins[0].numel() > 1e6
            iters = 10 if big else 20
            times = {names[0]: (cuda_ms(fwd, iters),
                                cuda_ms(lambda: plain(ins), max(2, iters // 2))),
                     names[1]: (cuda_ms(bwd, iters),
                                _time_backward(plain, ins, cots, diff, max(2, iters // 2)))}
            for name, (err, limit) in ((names[0], (fwd_err, tol)), (names[1], (bwd_err, gtol))):
                row = {"kernel": name, "shape": label, "dtype": str(dtype).split(".")[-1],
                       **desc, "max_abs_err": err[0], "rel_err": err[1], "tol": limit,
                       "ok": err[1] <= limit}
                if name == names[1]:
                    row["weight_grads_bit_identical"] = identical
                    row["rel_err_each"] = per_grad
                row["ms"], row["plain_ms"] = times[name]
                # the float32 kernel's time at this shape, from this call
                f32 = [r for r in rows if r["kernel"] == name and r["shape"] == label
                       and r["dtype"] == "float32"]
                row["design"] = (tat_design if is_tat else spatial_design)(dtype)
                row["f32_ms"] = (row["ms"] if dtype == torch.float32
                                 else f32[0]["ms"] if f32 else None)
                if split is not None:
                    row["split_check"] = split
                row["bound_ms"], row["bound_by"], row["flops"], *design = bounds[name]
                if design:  # the bound with the bf16 passes' own intermediates
                    row["design_ms"] = design[0]
                print("fused", json.dumps(row), flush=True)
                check(row["ok"], f"{name} vs plain at {label} {dtype}: "
                                 f"{row['rel_err']:.3g} > {limit}")
                check(split is None or split["ok"],
                      f"the float32 {name} split check at {label}: {split}")
                check(row.get("weight_grads_bit_identical", True),
                      f"{name} weight gradients differ between two launches at {label} {dtype}")
                rows.append(row)
            del ins, cots, ops, fwd, bwd, kern, plain
            torch.cuda.empty_cache()
    return rows


# kernel-name fragments of each pass: the float32 and the bf16 kernel of a
# pass share one
SPATIAL_PASSES = {
    "forward": (("sa", ("sp_embed_kernel", "sp_embed_wmma", "sp_embed_chunk")),
                ("stats", ("sp_colstats",)), ("cols", ("sp_cols_fwd",))),
    "backward": (("sa", ("sp_embed_kernel", "sp_embed_wmma", "sp_embed_chunk")),
                 ("stats", ("sp_colstats",)),
                 ("cols", ("sp_cols_bwd",)), ("ds", ("sp_ds_kernel", "sp_dk_sum")),
                 ("dq", ("sp_dq_kernel",)), ("rows", ("sp_rows_bwd",)),
                 ("embed_bwd", ("sp_embed_bwd_kernel", "sp_embed_bwd_chunk")),
                 ("atb", ("atb_partial_kernel",)), ("colsum", ("colsum_kernel",))),
}


def _profile_passes(run, iters, passes):
    """torch.profiler over ``iters`` calls of ``run``: device ms per call of
    each kernel, summed by pass; "other" is the tensor ops around the
    launches."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    kernels = {e.key[:90]: e.self_device_time_total / 1e3 / iters
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    out = {name: sum(v for k, v in kernels.items() if any(f in k for f in frags))
           for name, frags in passes}
    out["other"] = sum(kernels.values()) - sum(out.values())
    return {"device_ms": sum(kernels.values()), "passes": out, "kernels": kernels}


def measure_spatial_passes(iters: int = 10, shape: str = "pems08_blocks2-4"):
    """The spatial forward (row 12) and backward (row 13) by pass at a
    spatial shape (PEMS08 blocks 2-4 unless given) in each dtype, through
    SpatialMiddle's autograd (an interface every version of the package
    has, so a checkout of another commit can be measured with the same
    function): the forward as a training step calls it, the backward
    through torch.autograd.grad; "colsum" is the fixed-order row sums
    (dΘ, dpos, dpb, dgs, dbs and atb's partials)."""
    _, B, N, F, T, C, Co, d, K, dk, dtypes = next(
        s for s in SPATIAL_SHAPES + SPATIAL_WIDE_SHAPES if s[0] == shape)
    out = {"shape": shape, "iters": iters}
    for dtype in dtypes:
        ins, cots = spatial_inputs(B, N, F, T, C, Co, d, K, dk, dtype, 0)
        leaves = [t.detach().clone().requires_grad_(i in SPATIAL_DIFF)
                  for i, t in enumerate(ins)]
        fwd = lambda: block_spatial_fused.SpatialMiddle.apply(*leaves, K, dk, SPATIAL_KEEP)
        y = fwd()
        inputs = [leaves[i] for i in SPATIAL_DIFF]
        bwd = lambda: torch.autograd.grad(y, inputs, cots, retain_graph=True)
        out[str(dtype).split(".")[-1]] = {
            "forward": _profile_passes(fwd, iters, SPATIAL_PASSES["forward"]),
            "backward": _profile_passes(bwd, iters, SPATIAL_PASSES["backward"])}
        del ins, cots, leaves, y, inputs
        torch.cuda.empty_cache()
    print("measure", json.dumps({"path": "spatial_passes", **out}), flush=True)
    return out


# kernel-name fragments of each TAt pass: the operand prep, the passes,
# and the weight-gradient products and row sums
TAT_PASSES = {
    "forward": (("prep", ("tat_prep_kernel",)), ("qkv", ("tat_qkv_kernel",)),
                ("attn", ("tat_attn_fwd_kernel", "tat_attn_fwd_chunk")),
                ("out_ln1", ("tat_out_kernel",))),
    "backward": (("prep", ("tat_prep_kernel",)), ("qkv", ("tat_qkv_kernel",)),
                 ("attn", ("tat_attn_fwd_kernel", "tat_attn_fwd_chunk")),
                 ("ln1_bwd", ("tat_ln1_bwd_kernel",)),
                 ("attn_bwd", ("tat_attn_bwd_kernel", "tat_attn_bwd_chunk")),
                 ("g_te", ("tat_gte_kernel",)),
                 ("atb", ("atb_partial_kernel", "atb_wmma_partial_kernel")),
                 ("colsum", ("colsum_kernel",))),
}


def measure_tat_passes(iters: int = 10, shape: str = "pems08_blocks2-4"):
    """The TAt forward (row 10) and backward (row 11) by pass at a TAt
    shape (PEMS08 blocks 2-4 unless given) in each dtype, through
    TatFused's autograd (an interface every version of the package has, so
    a checkout of another commit can be measured with the same function):
    the forward as a training step calls it, the backward through
    torch.autograd.grad; "atb" is the weight-gradient products, "colsum"
    the fixed-order row sums."""
    _, BF, T, N, H, dk, dv, embed, _ = next(s for s in TAT_SHAPES + TAT_WIDE_SHAPES
                                            if s[0] == shape)
    out = {"shape": shape, "iters": iters}
    for dtype in F32_BF16:
        ins, cots = tat_inputs(BF, T, N, H, dk, dv, dtype, 0)
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        fwd = lambda: tat_fused.TatFused.apply(*leaves, H, dk, dv, embed)
        outs = fwd()
        bwd = lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True,
                                          allow_unused=True)
        dims = dict(n_heads=H, d_k=dk, d_v=dv, embed=embed)
        plain = lambda: tat_fused.tat_fused_plain(*leaves, **dims)
        outs_p = plain()
        bwd_p = lambda: torch.autograd.grad(outs_p, leaves, cots, retain_graph=True,
                                            allow_unused=True)
        out[str(dtype).split(".")[-1]] = {
            "forward": _profile_passes(fwd, iters, TAT_PASSES["forward"]),
            "backward": _profile_passes(bwd, iters, TAT_PASSES["backward"]),
            # the plain version's device time beside its CUDA-event time
            "plain": {"forward": {"ms": cuda_ms(plain, iters),
                                  **_profile_passes(plain, iters, ())},
                      "backward": {"ms": cuda_ms(bwd_p, iters),
                                   **_profile_passes(bwd_p, iters, ())}}}
        del ins, cots, leaves, outs, outs_p
        torch.cuda.empty_cache()
    print("measure", json.dumps({"path": "tat_passes", "torch": torch.__version__, **out}),
          flush=True)
    return out


# kernel-name fragments of each K1 pass (an older checkout's float32
# CUDA-core kernels share them): dA, dΘ, and the fixed-order reduce of the
# dΘ partials
K1_PASSES = (("dA", ("k1_dA",)), ("dtheta", ("k1_dtheta",)),
             ("reduce", ("k1_reduce", "colsum_kernel")))
# kernel-name fragments of K2's passes: Θ's split and the dx pass (the
# tensor-core kernel; k2_kernel names an older checkout's float32 one)
K2_PASSES = (("theta_split", ("k2_theta_split",)), ("dx", ("k2_kernel", "k2_wmma_kernel")))
# kernel-name fragments of each F pass: the weights pass and the SpMM with
# its Θ mix (the tensor-core kernel, or an older checkout's CUDA-core one)
F_PASSES = (("weights", ("weights_kernel",)), ("spmm", ("spmm",)))
# PERF.md rows 2-7's shapes: GAMBIA blocks 1 and 2 and the 17-slot random graph
BELL_ROW_SHAPES = ("gambia_block1", "gambia_block2", "random1pct_n2139")


def seeded_w(t: dict, shape, seed: int, dtype) -> torch.Tensor:
    """Attention weights from the generator alone, zero on inactive slots:
    active_softmax sums with index_add_, whose float atomics may change the
    last bits from run to run, so outputs compared by their bits take these."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pattern = t["active_pattern"][None, :, None]
    return (torch.rand(shape, generator=g, device="cuda") * pattern).to(dtype).contiguous()


def _digest(ys) -> list:
    """sha256 of each output's bytes (a tensor or a tuple of them; bf16
    widened to float32, exactly)."""
    return [hashlib.sha256(y.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()
            for y in (ys if isinstance(ys, (tuple, list)) else (ys,))]


def measure_bell(kernel: str, iters: int = 10) -> dict:
    """F (rows 2-3: the weights and SpMM/mix passes), K1 (rows 4-5: dA, dΘ
    and the fixed-order reduce of the dΘ partials) or K2 (rows 6-7: Θ's
    split and dx) at BELL_ROW_SHAPES in each dtype through its wrapper
    (``bell_forward_cuda``, ``bell_k1_cuda``, ``bell_k2_cuda``: interfaces
    every version of the package has, so a checkout of another commit is
    measured with the same function): three CUDA-event timings of ``iters``
    calls, device ms by pass (torch.profiler; "other" is the wrapper's
    allocations and casts) and the sha256 of its outputs (w from
    :func:`seeded_w`), with which two commits' bits are compared."""
    out = {"iters": iters}
    for seed, (label, kind, B, H, C, T, Co, BS, dk) in enumerate(BELL_SHAPES):
        if label not in BELL_ROW_SHAPES:
            continue
        bell = bell_graph(kind, BS)
        t = bell.tensors
        for dtype in F32_BF16:
            z = bell_inputs(bell, B, H, C, T, Co, dk, dtype, seed)
            w = seeded_w(t, z["w"].shape, 400 + seed, dtype)
            run, passes = {
                "F": (lambda: bell_fused.bell_forward_cuda(
                    t["tile_start"], t["tile_count"], t["active_src"], z["q"], z["k"],
                    z["bias"], z["cheb"], z["x"], z["thetas"]), F_PASSES),
                "K1": (lambda: bell_bwd.bell_k1_cuda(
                    t["active_src"], t["active_tgt"], t["tile_start"], t["tile_count"],
                    z["thetas"], z["gm"], z["x"], w), K1_PASSES),
                "K2": (lambda: bell_bwd.bell_k2_cuda(
                    t["src_start"], t["src_count"], t["src_order"], t["active_tgt"],
                    z["thetas"], z["gm"], w), K2_PASSES)}[kernel]
            out[f"{label}_{str(dtype).split('.')[-1]}"] = {
                "ms": [cuda_ms(run, iters) for _ in range(3)],
                **_profile_passes(run, iters, passes), "bits": _digest(run())}
            del z, w, run
            torch.cuda.empty_cache()
    path = {"F": "f_passes", "K1": "k1_passes", "K2": "k2"}[kernel]
    print("measure", json.dumps({"path": path, **out}), flush=True)
    return out


# TAt shapes measure_rows times by pass: GAMBIA's T = 144 at N = 8600 (LN1's
# row in nine column chunks)
TAT_PASS_SHAPES = {"t144_n8600": (128, 144, 8600, 2, 32, 32, False)}


def measure_rows(out: Path, iters: int = 20) -> dict:
    """PERF.md rows 2-13, both dtypes: F, K1 and K2 at BELL_ROW_SHAPES
    (:func:`measure_bell`: CUDA events, device time by pass, output
    digests); by CUDA events the TAt forward and
    backward kernels at PEMS08 blocks 2-4 and at GAMBIA's T = 144 and the
    spatial middle's at PEMS08 blocks 2-4 (with their outputs' digests,
    ``digests``), the GTU's at the GAMBIA block and at C = 128 (several
    chunks of C), and
    the TAt at TAT_PASS_SHAPES by pass (device time, torch.profiler),
    through interfaces every version of the package has
    (``tat_forward_cuda``/``tat_backward_cuda``, ``pack`` and
    ``gtu_forward_cuda``/``gtu_backward_cuda``), so a checkout of another
    commit is measured with the same function (``--rows OUT`` from that
    checkout, as ``--compare``; a shape that checkout's wrappers refuse
    reads "refused"). Writes and returns {"bell": {F, K1, K2: {shape_dtype:
    ...}}}, {row: {dtype: (ms forward, ms backward)}} and {passes: {shape:
    {dtype: ...}}}."""
    res = {"package": tat_fused.__file__, "card": card_line(), "passes": {},
           "bell": {k: measure_bell(k, iters) for k in ("F", "K1", "K2")}}

    def timed_or_refused(fwd, bwd):
        try:
            return cuda_ms(fwd, iters), cuda_ms(bwd, iters)
        except ValueError as e:  # an older checkout's card gate
            return f"refused: {e}"
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for label in ("pems08_blocks2-4", "gambia_t144"):
            _, BF, T, N, H, dk, dv, embed, _ = next(s for s in TAT_SHAPES if s[0] == label)
            dims = dict(n_heads=H, d_k=dk, d_v=dv, embed=embed)
            ins, cots = tat_inputs(BF, T, N, H, dk, dv, dtype, 1)
            res.setdefault(f"tat_{label}", {})[name] = timed_or_refused(
                lambda: tat_fused.tat_forward_cuda(*ins, **dims),
                lambda: tat_fused.tat_backward_cuda(*ins, *cots, **dims))
            res.setdefault("digests", {})[f"tat_{label}_{name}"] = _digest(
                [*tat_fused.tat_forward_cuda(*ins, **dims),
                 *tat_fused.tat_backward_cuda(*ins, *cots, **dims)])
            del ins, cots
        for label, (BF, T, N, H, dk, dv, embed) in TAT_PASS_SHAPES.items():
            dims = dict(n_heads=H, d_k=dk, d_v=dv, embed=embed)
            ins, cots = tat_inputs(BF, T, N, H, dk, dv, dtype, 1)
            try:
                res["passes"].setdefault(label, {})[name] = {
                    "forward": _profile_passes(
                        lambda: tat_fused.tat_forward_cuda(*ins, **dims), max(2, iters // 4),
                        TAT_PASSES["forward"])["passes"],
                    "backward": _profile_passes(
                        lambda: tat_fused.tat_backward_cuda(*ins, *cots, **dims),
                        max(2, iters // 4), TAT_PASSES["backward"])["passes"]}
            except ValueError as e:  # an older checkout's card gate
                res["passes"].setdefault(label, {})[name] = f"refused: {e}"
            del ins, cots
        _, B, N, F, T, C, Co, d, K, dk, _ = next(s for s in SPATIAL_SHAPES
                                                if s[0] == "pems08_blocks2-4")
        ins, cots = spatial_inputs(B, N, F, T, C, Co, d, K, dk, dtype, 1)
        ops = block_spatial_fused._kernel_operands(*ins)
        kd = dict(K=K, d_k=dk, keep=SPATIAL_KEEP, bf16=dtype == torch.bfloat16)
        y = block_spatial_fused.spatial_forward_cuda(*ops, **kd)
        mask, g32 = y > 0, cots[0].float().contiguous()
        res.setdefault("spatial_pems08_blocks2-4", {})[name] = timed_or_refused(
            lambda: block_spatial_fused.spatial_forward_cuda(*ops, **kd),
            lambda: block_spatial_fused.spatial_backward_cuda(*ops, g32, mask, **kd))
        res.setdefault("digests", {})[f"spatial_pems08_blocks2-4_{name}"] = _digest([y])
        del ins, cots, ops, y, mask, g32
        for label in ("gambia_block", "gambia_c128"):
            _, B, N2, C, T2, _ = next(s for s in GTU_SHAPES if s[0] == label)
            ins, cots = gtu_inputs(B, N2, C, T2, dtype, 0)
            wp, bp = gtu_fused.pack(*ins[1:], dtype)
            x, g = ins[0], cots[0].contiguous()
            res.setdefault(f"gtu_{label}", {})[name] = timed_or_refused(
                lambda: gtu_fused.gtu_forward_cuda(x, wp, bp),
                lambda: gtu_fused.gtu_backward_cuda(x, g, wp, bp))
            del ins, cots, wp, bp, x, g
        torch.cuda.empty_cache()
    print("rows", json.dumps(res), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return res


def forward_bits(path: Path) -> dict:
    """The float32 kernels' outputs on seeded operands: the spatial forward
    at every float32 spatial shape, the TAt forward and backward at every
    float32 TAt shape, and K1's dA and dΘ, K2's dx and F's output at every
    BELL shape (F's q, k and tiles from the generator). Saved to
    ``path`` (as sha256 digests of the bytes) where it does not exist yet,
    else held against the saved digests: equal bits or not. Run from
    checkouts of two commits in turns (``--compare``), it shows whether a
    change keeps the float32 kernels' bits."""
    outs = {}
    for seed, (label, B, N, F, T, C, Co, d, K, dk, dtypes) in enumerate(SPATIAL_SHAPES):
        if torch.float32 not in dtypes:
            continue
        ins, _ = spatial_inputs(B, N, F, T, C, Co, d, K, dk, torch.float32, 100 + seed)
        ops = block_spatial_fused._kernel_operands(*ins)
        outs[label] = block_spatial_fused.spatial_forward_cuda(
            *ops, K=K, d_k=dk, keep=SPATIAL_KEEP, bf16=False).cpu()
    for seed, (label, BF, T, N, H, dk, dv, embed, dtypes) in enumerate(TAT_SHAPES):
        if torch.float32 not in dtypes:
            continue
        ins, cots = tat_inputs(BF, T, N, H, dk, dv, torch.float32, 200 + seed)
        dims = dict(n_heads=H, d_k=dk, d_v=dv, embed=embed)
        fwd = tat_fused.tat_forward_cuda(*ins, **dims)
        bwd = tat_fused.tat_backward_cuda(*ins, *cots, **dims)
        outs[f"tat_{label}"] = [t.cpu() for t in (*fwd, *bwd)]
    for seed, (label, kind, B, H, C, T, Co, BS, dk) in enumerate(BELL_SHAPES):
        bell = bell_graph(kind, BS)
        t = bell.tensors
        z = bell_inputs(bell, B, H, C, T, Co, dk, torch.float32, 300 + seed)
        w = seeded_w(t, z["w"].shape, 400 + seed, torch.float32)
        k1 = bell_bwd.bell_k1_cuda(t["active_src"], t["active_tgt"], t["tile_start"],
                                   t["tile_count"], z["thetas"], z["gm"], z["x"], w)
        outs[f"k1_{label}"] = list(k1)
        outs[f"k2_{label}"] = bell_bwd.bell_k2_cuda(t["src_start"], t["src_count"],
                                                    t["src_order"], t["active_tgt"],
                                                    z["thetas"], z["gm"], w)
        outs[f"f_{label}"] = bell_fused.bell_forward_cuda(
            t["tile_start"], t["tile_count"], t["active_src"], z["q"], z["k"], z["bias"],
            z["cheb"], z["x"], z["thetas"])
        del z, w, k1
    outs = {label: _digest(ys) for label, ys in outs.items()}
    if not path.exists():
        path.write_text(json.dumps(outs))
        result = {"saved": str(path)}
    else:
        want = json.loads(path.read_text())
        result = {label: ys == want[label] for label, ys in outs.items()}
        differ = [label for label, same in result.items() if not same]
        check(not differ, f"float32 kernel bits differ from {path} at {differ}")
    print("forward_bits", json.dumps(result), flush=True)
    return result


def compare_run(out: Path) -> dict:
    """One side of a comparison of two commits in one chip call: the float32
    kernels' bits (against the first side's, saved beside ``out``), cheb_sat
    at its four main shapes, F, K1 and K2 by pass at GAMBIA blocks 1-2 and
    on the 17-slot random graph, and the GAMBIA dense (use_pallas) and
    BELL-tiles bf16 epochs with and without fuse_gtu (ms/step, device time,
    epoch peak memory, the profile's ops by input shape), written to
    ``out``. Run it from a checkout of each commit in turns (parent, change,
    change, parent), loading this file with importlib so that each
    checkout's own package is imported. The spatial and TAt passes are
    measured by ``--measure``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    result = {"card": card_line(), "forward_bits": forward_bits(out.parent / "forward_bits.json"),
              "cheb_sat": measure_cheb_sat(),
              "k1_passes": measure_bell("K1"), "f_passes": measure_bell("F"),
              "k2": measure_bell("K2")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        result["gambia_dense"] = measure_gambia_fuse_gtu(Path(tmp), rounds=3, paths=("dense",))
        result["gambia_bell_tiles"] = measure_gambia_fuse_gtu(Path(tmp), rounds=3,
                                                              paths=("bell_tiles",))
    out.write_text(json.dumps(result, indent=1))
    return result


# ---------------------------------------------------------------------------
# phase 2d: the fused GTU kernels vs their plain version
# ---------------------------------------------------------------------------

GTU_SHAPES = [
    # (label, B, N, C, T, dtypes): the GAMBIA block (both blocks alike), the
    # JAX test's two shapes, a ragged one (B·N odd, no T_out a multiple of
    # 16), C = 48 (channel groups of 16); at GAMBIA's B·N = 8556 the shapes
    # the untiled kernels refused: one and two days of five-minute
    # readings (T = 288, 576; time tiles with their halo) and
    # nb_time_filter = 64 and 128 (channel groups, C in chunks of 64);
    # and C = 80 (groups of 16, a ragged last chunk) at T = 96
    ("gambia_block", 4, 2139, 32, 144, F32_BF16),
    ("jax_test_n10", 2, 10, 16, 48, F32_BF16),
    ("jax_test_n3", 1, 3, 32, 64, F32_BF16),
    ("ragged_bn21", 3, 7, 16, 80, F32_BF16),
    ("c48_t144", 4, 512, 48, 144, F32_BF16),
    ("gambia_t288", 4, 2139, 32, 288, F32_BF16),
    ("gambia_t576", 4, 2139, 32, 576, F32_BF16),
    ("gambia_c64", 4, 2139, 64, 144, F32_BF16),
    ("gambia_c128", 4, 2139, 128, 144, F32_BF16),
    ("c80_t96", 1, 37, 80, 96, F32_BF16),
]
# the GTU shapes past the untiled kernels' caps (PERF.md's sub-table)
GTU_NEW_SHAPES = ("gambia_t288", "gambia_t576", "gambia_c64", "gambia_c128")
# the float32 GTU's split check (SPLIT_TOL, gtu_nosplit_plain) at the GAMBIA
# block (one resident chunk) and at C = 128 (chunks of C streamed)
GTU_SPLIT_SHAPES = ("gambia_block", "gambia_c128")


def gtu_design(dtype) -> str:
    """The arithmetic of a GTU kernel, one tiled design in both dtypes on
    the tensor cores (WMMA): bf16 operands as they are, float32 x, taps and
    dY split hi/lo (three bf16 products each)."""
    return "wmma_bf16" if dtype == torch.bfloat16 else "wmma_f32_split"


def check_gtu_smem():
    """The kernels' own tiling and shared memory at every GTU shape and at
    every 16 | C up to 512 and 16 | T from 48 to 1024: gtu_fused_smem_bytes
    of each kernel (kinds 0-3: float32 and bf16, forward and backward)
    within a block's 227 KiB, and gtu_fused_plan's channel group dividing
    C, its time tiles covering T and a halo exactly where there are
    several (several resident chunks in bf16 only)."""
    lib = gtu_fused._load()
    shapes = {(s[3], s[4]) for s in GTU_SHAPES} | {
        (C, T) for C in range(16, 513, 16) for T in range(48, 1025, 16)}
    out = (ctypes.c_int * 7)()
    for C, T in sorted(shapes):
        for kind in range(4):
            got = lib.gtu_fused_smem_bytes(C, T, kind)
            check(0 < got <= 227 * 1024, f"gtu kernel {kind} at C={C}, T={T} requests "
                                         f"{got} bytes of shared memory")
        for is_bf16 in (0, 1):
            lib.gtu_fused_plan(1, C, T, is_bf16, out)
            G, CK, res, TT, ntt, halo = tuple(out)[:6]
            check(C % G == 0 and C % CK == 0 and TT % 16 == 0 and TT * ntt >= T
                  and (TT * (ntt - 1) < T) and halo == (16 if ntt > 1 else 0)
                  and res in (0, 1) and (res == 0 or CK == C or is_bf16),
                  f"gtu plan at C={C}, T={T}, bf16={is_bf16}: {tuple(out)[:6]}")


def gtu_bounds(B, N, C, T, dtype):
    """(bound_ms, bound_by, flops) of the GTU forward and backward: the
    useful products (no zero taps) with operands in the compute dtype (bf16:
    989 TFLOP/s), the backward three times them (recompute, dx, dW); bytes:
    x and the output (backward: x, g and dx) once, the float32 taps and
    biases read once (and their gradients written once)."""
    BN, xb = B * N, (2 if dtype == torch.bfloat16 else 4)
    M3 = gtu_fused.out_len(T)
    fwd = 2 * BN * sum((T - k + 1) * k for k in gtu_fused.KS) * C * 2 * C
    weights = 4 * (gtu_fused.TAPS * 2 * C * C + 3 * 2 * C)
    return {"gtu_fwd": _bound(fwd, xb * BN * (C * T + M3 * C) + weights, dtype),
            "gtu_bwd": _bound(3 * fwd, xb * BN * (2 * C * T + M3 * C) + 2 * weights, dtype)}


def gtu_inputs(B, N, C, T, dtype, seed):
    """x, the three convs' OIHW weights and biases (PyTorch's default init
    scale), and a cotangent of the output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ins = [_randn(g, B, N, C, T)]
    for k in gtu_fused.KS:
        ins += [_randn(g, 2 * C, C, 1, k, scale=(C * k) ** -0.5), _randn(g, 2 * C, scale=0.1)]
    cot = _randn(g, B, N, gtu_fused.out_len(T), C)
    return [t.to(dtype).contiguous() for t in ins], [cot.to(dtype)]


def gtu_library(ins):
    """The closest single PyTorch call, conv only, no gate: one cuDNN conv2d
    with the packed (6C, C, 1, 7) weights (the k = 3 and 5 taps zero-padded)
    on x as (B·N, C, 1, T); its forward and its autograd backward."""
    x, ws = ins[0], ins[1::2]
    B, N, C, T = x.shape
    w = torch.cat([torch.nn.functional.pad(w, (0, 7 - w.shape[-1])) for w in ws])
    b = torch.cat(ins[2::2])
    xv = x.reshape(B * N, C, 1, T)
    fwd = lambda: torch.nn.functional.conv2d(xv, w, b)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xv, w, b)]
    out = torch.nn.functional.conv2d(*leaves)
    g = torch.ones_like(out)
    bwd = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    iters = 10 if x.numel() > 1e6 else 20
    return cuda_ms(fwd, iters), cuda_ms(bwd, iters)


def gtu_nosplit_plain(x, w3, b3, w5, b5, w7, b7):
    """The control of the GTU's split check: the plain version in float32
    as a design without the lo terms computes it, x and the taps rounded to
    bf16 before the products and, in the backward, dY (the products'
    cotangent, so dx and dW take its hi term only); the gate and every sum
    float32. Gradients from autograd."""
    r = _RoundValue.apply
    C, T = x.shape[2], x.shape[3]
    xt = r(x.float()).transpose(2, 3)
    outs = []
    for k, w, b in zip(gtu_fused.KS, (w3, w5, w7), (b3, b5, b7)):
        T_out = T - k + 1
        wr = r(w.float())
        y = b.float()
        for kk in range(k):
            y = y + xt[:, :, kk:kk + T_out] @ wr[:, :, 0, kk].t()
        y = _RoundCotangent.apply(y)
        outs.append(torch.tanh(y[..., :C]) * torch.sigmoid(y[..., C:]))
    return torch.cat(outs, dim=2)


def gtu_split_check(ins, cots, fwd_err, outs_p, grads_p, grads_k) -> dict:
    """The float32 GTU within SPLIT_TOL of the plain float32 version in the
    output and every gradient, where :func:`gtu_nosplit_plain` must exceed
    it in the output, in dx and in each conv's dW."""
    diff = tuple(range(7))
    outs_c, grads_c = _grad_run(lambda a: gtu_nosplit_plain(*a), ins, cots, diff)
    each = lambda gs: [rel_err(g, p)[1] for g, p in zip(gs, grads_p)]
    kern, ctl = each(grads_k), each(grads_c)
    out = {"fwd_rel_err": fwd_err, "bwd_rel_err": max(kern), "tol": SPLIT_TOL,
           "nosplit_fwd_rel_err": _compare(outs_c, outs_p)[1],
           "nosplit_dx_rel_err": ctl[0], "nosplit_dw_rel_err": [ctl[1], ctl[3], ctl[5]]}
    out["ok"] = max(fwd_err, max(kern)) <= SPLIT_TOL < min(
        out["nosplit_fwd_rel_err"], ctl[0], ctl[1], ctl[3], ctl[5])
    return out


def phase_gtu_kernels():
    """The GTU forward and backward against their plain version at every
    GTU shape, float32 and bfloat16 (:func:`gtu_rows`)."""
    check_gtu_smem()
    rows = []
    for seed, (label, B, N, C, T, dtypes) in enumerate(GTU_SHAPES):
        for dtype in dtypes:
            rows += gtu_rows(label, B, N, C, T, dtype, seed)
            torch.cuda.empty_cache()
    return rows


def gtu_rows(label: str, B: int, N: int, C: int, T: int, dtype, seed: int) -> list:
    """The GTU forward and backward against their plain version at one
    shape: the output and every gradient through GtuCat, dW and db equal
    bit for bit over two backward launches, the float32 split check at
    GTU_SPLIT_SHAPES, and CUDA-event times of the kernels, the plain version
    and the conv-only library call; its two rows (forward, backward)."""
    rows = []
    diff = tuple(range(7))
    tol, gtol = FUSED_TOL[dtype]
    ins, cots = gtu_inputs(B, N, C, T, dtype, seed)
    kern = lambda a: gtu_fused.GtuCat.apply(*a)
    plain = lambda a: gtu_fused.gtu_cat_plain(*a)
    outs_k, grads_k = _grad_run(kern, ins, cots, diff)
    outs_p, grads_p = _grad_run(plain, ins, cots, diff)
    torch.cuda.synchronize()
    fwd_err, bwd_err = _compare(outs_k, outs_p), _compare(grads_k, grads_p)
    per_grad = [rel_err(k, p)[1] for k, p in zip(grads_k, grads_p)]
    split = (gtu_split_check(ins, cots, fwd_err[1], outs_p, grads_p, grads_k)
             if dtype == torch.float32 and label in GTU_SPLIT_SHAPES else None)
    del outs_k, grads_k, outs_p, grads_p
    wp, bp = gtu_fused.pack(*ins[1:], dtype)
    x, g = ins[0], cots[0].contiguous()
    first, again = (gtu_fused.gtu_backward_cuda(x, g, wp, bp) for _ in range(2))
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(first[1:], again[1:]))
    del first, again
    iters = 10 if x.numel() > 1e6 else 20
    lib_fwd, lib_bwd = gtu_library(ins)
    times = {"gtu_fwd": (cuda_ms(lambda: gtu_fused.gtu_forward_cuda(x, wp, bp), iters),
                         cuda_ms(lambda: plain(ins), max(2, iters // 2)), lib_fwd),
             "gtu_bwd": (cuda_ms(lambda: gtu_fused.gtu_backward_cuda(x, g, wp, bp),
                                 iters),
                         _time_backward(plain, ins, cots, diff, max(2, iters // 2)),
                         lib_bwd)}
    bounds = gtu_bounds(B, N, C, T, dtype)
    for name, err, limit in (("gtu_fwd", fwd_err, tol), ("gtu_bwd", bwd_err, gtol)):
        row = {"kernel": name, "shape": label, "dtype": str(dtype).split(".")[-1],
               "design": gtu_design(dtype),
               "B": B, "N": N, "C": C, "T": T, "max_abs_err": err[0],
               "rel_err": err[1], "tol": limit, "ok": err[1] <= limit}
        if name == "gtu_bwd":
            row["dw_db_bit_identical"] = identical
            row["rel_err_each"] = per_grad
        if split is not None:
            row["split_check"] = split
        row["ms"], row["plain_ms"], row["library_ms"] = times[name]
        row["library"] = "conv2d (6C, C, 1, 7), conv only, no gate"
        row["bound_ms"], row["bound_by"], row["flops"] = bounds[name]
        print("gtu", json.dumps(row), flush=True)
        check(row["ok"], f"{name} vs plain at {label} {dtype}: "
                         f"{row['rel_err']:.3g} > {limit}")
        check(row.get("dw_db_bit_identical", True),
              f"GTU dW/db differ between two launches at {label} {dtype}")
        check(split is None or split["ok"],
              f"float32 GTU split check at {label}: {split}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 3: PEMS08 full width through the CLI
# ---------------------------------------------------------------------------

PEMS08_TRAINING = dict(nb_block=4, n_heads=3, K=3, d_k=32, d_model=512,
                       nb_chev_filter=32, nb_time_filter=32, batch_size=64,
                       learning_rate=0.0001, seed=2024)


def write_project_conf(root: Path, name: str, data: str, n: int, dataset: str,
                       adj: str, stag: str, strg: str, graph: str,
                       model_name: str = "dstagnn", hours: int = 1, **training) -> Path:
    """A reference-format config ``<name>.conf`` for the windowed npz
    ``<data>_r<hours>_d0_w0_dstagnn.npz`` under ``root``: ``n`` nodes,
    12·``hours`` steps in (the last 12 five-minute readings of each hour), 12 out,
    one feature, the graph files given; the PEMS08 widths
    (``PEMS08_TRAINING``, 2 epochs, ``use_pallas``, float32) with
    ``training``'s keys over them."""
    keys = {"epochs": 2, "use_pallas": "true", "compute_dtype": "float32",
            **PEMS08_TRAINING, **training}
    body = "\n".join(f"{k} = {v}" for k, v in keys.items())
    conf = root / f"{name}.conf"
    conf.write_text(f"""[Data]
adj_filename = {adj}
graph_signal_matrix_filename = {root}/{data}.npz
stag_filename = {stag}
strg_filename = {strg}
num_of_vertices = {n}
points_per_hour = 12
num_for_predict = 12
len_input = {12 * hours}
dataset_name = {dataset}

[Training]
model_name = {model_name}
in_channels = 1
graph = {graph}
num_of_hours = {hours}
num_of_days = 0
num_of_weeks = 0
{body}
""")
    return conf


def write_pems08_project(root: Path, name: str = "SYNTH08", model_name: str = "dstagnn",
                         **training) -> Path:
    """The in-repo parity dataset as a reference-format project: windowed
    npz plus headerless CSVs, with graph = AG so the loaders return ``adj``
    as adj_merge (binarized STAG) and ``stag`` as adj_pa (binarized STRG).
    ``model_name`` is the model family; ``training`` overrides other
    [Training] keys; the config is ``<name>.conf``."""
    with np.load(REPO / "benchmarks" / "parity_runs" / "parity_dataset.npz") as f:
        np.savez(root / "SYNTH08_r1_d0_w0_dstagnn.npz",
                 train_x=f["train_x"], train_target=f["train_y"],
                 val_x=f["val_x"], val_target=f["val_y"],
                 test_x=f["test_x"], test_target=f["test_y"],
                 mean=f["mean"], std=f["std"])
        np.savetxt(root / "adj.csv", f["adj"], delimiter=",")
        np.savetxt(root / "stag.csv", f["adj"], delimiter=",")
        np.savetxt(root / "strg.csv", f["stag"], delimiter=",")
        n = f["adj"].shape[0]
    return write_project_conf(root, name, "SYNTH08", n, "SYNTH08", f"{root}/adj.csv",
                              f"{root}/stag.csv", f"{root}/strg.csv", "AG",
                              model_name=model_name, **training)


def run_pems08_cli(root: Path, conf: Path, exp: Path, args=(), epochs: int = 2):
    """The training CLI for ``epochs`` epochs on a project of
    :func:`write_project_conf` (its windowed npz, nodes, dataset name and
    batch read from ``conf``), with every launch count set to 0 just before
    and read just after. Checks finite (and, over 2 epochs, falling)
    losses, a checkpoint, the test dump and the report. Returns (summary,
    launches, forward passes, the CLI's trainer, run dir)."""
    from dstagnn_drought_tpu_torch.cli import train as train_cli
    from dstagnn_drought_tpu_torch.config import load_config

    cfg = load_config(conf)
    data, dataset = Path(cfg.data.graph_signal_matrix_filename).stem, cfg.data.dataset_name
    n, hours = cfg.data.num_of_vertices, cfg.training.num_of_hours
    with np.load(root / f"{data}_r{hours}_d0_w0_dstagnn.npz") as f:
        sizes = {s: len(f[f"{s}_x"]) for s in ("train", "val", "test")}
    bs = cfg.training.batch_size
    batches = {s: -(-n // bs) for s, n in sizes.items()}
    forwards = epochs * (batches["train"] + batches["val"]) + batches["test"]
    steps = epochs * batches["train"]

    reset_launches()
    with trainers_made() as made:
        result = train_cli.main(["--config", str(conf), "--epochs", str(epochs),
                                 "--experiments-root", str(exp), *args])
    torch.cuda.synchronize()
    launches = launches_run(read_launches(), made)

    run_dir = next(exp.glob(f"{dataset}/*"))
    events = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    ep = [e for e in events if e["event"] == "epoch"]
    losses = [e["train_loss"] for e in ep]
    check(len(ep) == epochs, f"expected {epochs} epoch records, got {len(ep)}")
    check(all(math.isfinite(v) for v in losses + [e["val_loss"] for e in ep]),
          f"non-finite losses {losses}")
    if epochs > 1:
        check(losses[1] < losses[0], f"epoch-2 loss {losses[1]} not below epoch-1 {losses[0]}")
    check(any(run_dir.glob("epoch_*.pt")), "no checkpoint written")
    dumps = list(run_dir.glob("output_epoch_*_test.npz"))
    check(len(dumps) == 1, "no test prediction dump")
    with np.load(dumps[0]) as d:
        pred = d["prediction"]
    check(pred.shape == (sizes["test"], n, 12) and bool(np.isfinite(pred).all()),
          f"bad test predictions {pred.shape}")
    overall = result["report"]["overall"]
    check(all(math.isfinite(overall[k]) for k in ("mae", "rmse", "mape")), "bad report")
    out = {"device": torch.cuda.get_device_name(0), "epochs": epochs, "train_losses": losses,
           "val_losses": [e["val_loss"] for e in ep], "test_overall": overall,
           "forward_passes": forwards, "train_steps": steps,
           f"ms_per_step_epoch{epochs}": ep[-1]["train_seconds"] / ep[-1]["steps"] * 1e3,
           "steps_per_epoch": ep[-1]["steps"], "graphs": graph_summary(made[0])}
    return out, launches, forwards, made[0], run_dir


def phase_pems08(root: Path):
    conf = write_pems08_project(root)
    nb = PEMS08_TRAINING["nb_block"]
    out, launches, forwards, _, _ = run_pems08_cli(root, conf, root / "exp", ["--use-pallas"])
    check(launches["cheb_sat"] == forwards * nb,
          f"cheb_sat launches {launches['cheb_sat']} != {forwards} forward passes x {nb} blocks")
    out = {"path": "pems08_cli", **out, "launches": launches["cheb_sat"]}
    print("main_path", json.dumps(out), flush=True)
    return out


FUSED_KEYS = dict(fuse_tat="true", fuse_spatial="true", compute_dtype="bfloat16")
# each TAt and spatial kernel once per block of every forward pass (forward)
# or train step (backward); the cheb_sat kernel not at all
FUSED_LAUNCHES = dict(per_forward=("tat_fwd", "spatial_fwd"),
                      per_step=("tat_bwd", "spatial_bwd"), never=("cheb_sat",))


def run_fused_cli(root: Path, conf: Path, path: str, model_check: bool = True,
                  launches: dict = FUSED_LAUNCHES, knobs=("fuse_tat", "fuse_spatial"),
                  measure: bool = False, nb: int = PEMS08_TRAINING["nb_block"]) -> dict:
    """The training CLI on a fused project (2 epochs), its launch counts
    checked (``launches``, per block of its ``nb``), the device memory peak over the run,
    and with ``model_check`` the whole-model check: the run's last
    checkpoint, one test batch in float32, the model with ``knobs`` on
    against it with them off. With ``measure``, one more epoch of the
    checkpoint's trainer for ms/step and its peak memory, and a profiled
    epoch for device ms/step and the busy share."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run, counts, _, trainer, run_dir = run_pems08_cli(root, conf, root / f"exp_{path}")
    out = {"path": path, **run, "launches": counts,
           "run_peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "cli_seconds": time.perf_counter() - t0}
    check_launches(out, **launches, nb=nb)
    if model_check or measure:
        t0 = time.perf_counter()
        trainer, last = checkpoint_trainer(trainer, run_dir)
        out["trainer_seconds"] = time.perf_counter() - t0
        if model_check:
            out["model_check"] = model_check_of(trainer, last, knobs)
        if measure:
            ms, peak = epoch_peak(trainer, 0)
            prof = profile_epoch(trainer, top=8)
            out["epoch"] = {"ms_per_step": ms, "epoch_peak_mib": peak,
                            "device_ms_per_step": prof["device_ms_per_step"],
                            "busy_share": prof["busy_share"], "steps": prof["steps"],
                            "top_kernels": prof["top_kernels"]}
        del trainer
        torch.cuda.empty_cache()
    print("main_path", json.dumps(out), flush=True)
    return out


def phase_pems08_fused(root: Path):
    """The main path of the fused slice: the training CLI with fuse_tat and
    fuse_spatial (bfloat16, use_pallas still set: fuse_spatial takes
    precedence) at full PEMS08 width (:func:`run_fused_cli`)."""
    conf = write_pems08_project(root, "SYNTH08F", **FUSED_KEYS)
    return run_fused_cli(root, conf, "pems08_cli_fused_bf16")


PEMS07_N = 883          # PEMS07's sensors (BASELINE.md; the DSTAGNN paper's dataset table)
PEMS07_SIZES = (96, 24, 24)  # windows a split: 8 train steps of 12, 2 val, 2 test
PEMS07_BATCH = 12       # the reference's PEMS07 batch


def synthetic_windows(root: Path, name: str, rng, N: int, T: int, sizes, hours: int = 1):
    """Numpy-seeded windows of a synthetic traffic signal at N nodes (a
    daily-like sine of a random phase per node and noise, five-minute
    steps), T steps in and 12 out, one feature, the inputs normalised and
    the targets in flow units, ``sizes`` windows in train, val and test:
    ``<name>_r<hours>_d0_w0_dstagnn.npz`` under ``root``."""
    L = sum(sizes) + T + 12
    t = np.arange(L, dtype=np.float64)[:, None]
    sig = (200 + 60 * np.sin(2 * np.pi * t / 48 + rng.uniform(0, 2 * np.pi, N))
           + 10 * rng.normal(size=(L, N)))
    n = L - T - 12
    x = np.stack([sig[i:i + T].T[:, None, :] for i in range(n)]).astype(np.float32)
    y = np.stack([sig[i + T:i + T + 12].T for i in range(n)]).astype(np.float32)
    n_tr, n_va, _ = sizes
    mean, std = x[:n_tr].mean(), x[:n_tr].std()
    x = (x - mean) / std
    cut = {"train": slice(0, n_tr), "val": slice(n_tr, n_tr + n_va),
           "test": slice(n_tr + n_va, None)}
    np.savez(root / f"{name}_r{hours}_d0_w0_dstagnn.npz",
             **{f"{k}_x": x[c] for k, c in cut.items()},
             **{f"{k}_target": y[c] for k, c in cut.items()},
             mean=np.full((1, 1, 1, 1), mean), std=np.full((1, 1, 1, 1), std))


def write_pems07_project(root: Path, name: str, seed: int = 7, **training) -> Path:
    """A PEMS07-width project: :func:`synthetic_windows` at N = 883 (12
    steps in, 12 out), a seeded sparse directed edge-list graph (a ring and
    N/2 random chords, the PEMS loaders' "from,to,cost" CSV) as ``graph =
    G``'s adjacency, and a seeded 2% STRG. No PEMS07 data is in the
    repository; the shapes are PEMS07's."""
    rng = np.random.default_rng(seed)
    N = PEMS07_N
    synthetic_windows(root, name, rng, N, 12, PEMS07_SIZES)
    chords = rng.integers(0, N, size=(N // 2, 2))
    edges = [(i, (i + 1) % N) for i in range(N)] + [(a, b) for a, b in chords if a != b]
    (root / f"{name}_adj.csv").write_text(
        "from,to,cost\n" + "".join(f"{a},{b},{rng.uniform(100, 1000):.1f}\n" for a, b in edges))
    strg = (rng.random((N, N)) < 0.02).astype(np.int8)
    np.fill_diagonal(strg, 1)
    np.savetxt(root / f"{name}_strg.csv", strg, fmt="%d", delimiter=",")
    strg_file = f"{root}/{name}_strg.csv"
    return write_project_conf(root, name, name, N, "PEMS07", f"{root}/{name}_adj.csv",
                              strg_file, strg_file, "G", use_pallas="false",
                              **{"batch_size": PEMS07_BATCH, **training})


def pems07_fused_projects(root: Path) -> dict:
    """The fused PEMS07-width projects, float32 and bf16: ``{dtype: conf}``."""
    return {dtype: write_pems07_project(root, f"SYNTH07{dtype[0].upper()}", fuse_tat="true",
                                        fuse_spatial="true", compute_dtype=dtype)
            for dtype in ("float32", "bfloat16")}


def phase_pems07_fused(root: Path):
    """This slice's main path: the training CLI with fuse_tat and
    fuse_spatial at PEMS07 width (N = 883, 4 blocks, T = 12, K = H = 3,
    d_k = 32, d_model = 512, C = 32, batch 12), 2 epochs in float32 and 2
    in bf16 (:func:`run_fused_cli`; the whole-model check on the float32
    run)."""
    return {dtype: run_fused_cli(root, conf, f"pems07_cli_fused_{dtype}",
                                 model_check=dtype == "float32")
            for dtype, conf in pems07_fused_projects(root).items()}


# the large-N and long-T paths: the fused TAt and GTU past the caps
# the card had before
LARGE_N = 8600               # LargeST California's sensors (LargeST, NeurIPS 2023)
LARGE_N_SIZES = (32, 16, 16)  # windows a split: 2 train steps of 16, 1 val, 1 test
LARGE_N_KEYS = dict(sparse="true", sparse_format="bell", mask_format="tiles", block_size=128,
                    rcm="true", fuse_tat="true", batch_size=16)
LARGE_N_LAUNCHES = dict(per_forward=("tat_fwd", "bell_fused"),
                        per_step=("tat_bwd", "bell_k1", "bell_k2"),
                        never=("cheb_sat", "spatial_fwd", "spatial_bwd", "gtu_fwd", "gtu_bwd"))
LONG_T_HOURS = 48            # 48 hours of 12 five-minute steps: T = 576, two days
LONG_T_SIZES = (32, 8, 8)    # 4 train steps of 8, 1 val, 1 test
LONG_T_KEYS = dict(fuse_tat="true", fuse_spatial="true", fuse_gtu="true", batch_size=8)
LONG_T_LAUNCHES = dict(per_forward=("tat_fwd", "spatial_fwd", "gtu_fwd"),
                       per_step=("tat_bwd", "spatial_bwd", "gtu_bwd"),
                       never=("cheb_sat", "bell_fused", "bell_k1", "bell_k2"))


def knn_adjacency(n: int, k: int = 8, seed: int = 11) -> np.ndarray:
    """A seeded k-nearest-neighbour graph on n uniform points of the unit
    square, symmetrised, with self loops (0/1 int8)."""
    from scipy.spatial import cKDTree

    pts = np.random.default_rng(seed).random((n, 2))
    _, idx = cKDTree(pts).query(pts, k=k + 1)  # each point's k nearest and itself
    A = np.zeros((n, n), np.int8)
    A[np.repeat(np.arange(n), k + 1), idx.ravel()] = 1
    return np.maximum(A, A.T)


def write_dense_csv(path: Path, A: np.ndarray) -> None:
    """A 0/1 matrix as headerless CSV, written as bytes (np.savetxt takes
    minutes at N = 8600)."""
    buf = np.full((A.shape[0], 2 * A.shape[1]), ord(","), np.uint8)
    buf[:, 0::2] = A.astype(np.uint8) + ord("0")
    buf[:, -1] = ord("\n")
    path.write_bytes(buf.tobytes())


def write_large_n_project(root: Path, dtype: str) -> Path:
    """DSTAGNN at PEMS08 widths on N = 8600: :func:`synthetic_windows` (12
    steps in, batch 16), the seeded 8-nearest-neighbour graph as the
    adjacency (``graph = G``), STAG and STRG, BELL tiles of 128 with RCM and
    fuse_tat, in ``dtype``."""
    name = f"CA{LARGE_N}{dtype[0].upper()}"
    synthetic_windows(root, name, np.random.default_rng(13), LARGE_N, 12, LARGE_N_SIZES)
    adj = root / f"knn{LARGE_N}.csv"
    if not adj.exists():
        write_dense_csv(adj, knn_adjacency(LARGE_N))
    return write_project_conf(root, name, name, LARGE_N, "LARGEST_CA", str(adj), str(adj),
                              str(adj), "G", compute_dtype=dtype, **LARGE_N_KEYS)


def phase_large_n(root: Path, measure: bool = False):
    """The fused TAt past its old N cap through the CLI (the large-N
    path): :func:`write_large_n_project`, 2 epochs in float32 and 2
    in bf16, the TAt and BELL launches checked per block, the float32 run's
    fused and unfused (plain TAt) models on one test batch, and with
    ``measure`` (``--measure``) an epoch each for ms/step, its peak memory,
    device ms/step and the busy share (:func:`run_fused_cli`)."""
    return {dtype: run_fused_cli(root, write_large_n_project(root, dtype),
                                 f"large_n_cli_{dtype}", model_check=dtype == "float32",
                                 launches=LARGE_N_LAUNCHES, knobs=("fuse_tat",), measure=measure)
            for dtype in ("float32", "bfloat16")}


def write_long_t_project(root: Path, dtype: str) -> Path:
    """DSTAGNN at PEMS08 width (N = 170, 4 blocks) on two days of
    five-minute readings in (T = 576, num_of_hours = 48, 12 out):
    :func:`synthetic_windows`, batch 8, a seeded 8-nearest-neighbour graph
    as adjacency, STAG and STRG, with fuse_tat, fuse_spatial and fuse_gtu in
    ``dtype``."""
    name = f"LONGT{dtype[0].upper()}"
    N = 170
    synthetic_windows(root, name, np.random.default_rng(17), N, 12 * LONG_T_HOURS, LONG_T_SIZES,
                      hours=LONG_T_HOURS)
    adj = root / f"knn{N}.csv"
    if not adj.exists():
        write_dense_csv(adj, knn_adjacency(N))
    return write_project_conf(root, name, name, N, "PEMS08_2DAY", str(adj), str(adj), str(adj),
                              "G", hours=LONG_T_HOURS, compute_dtype=dtype, **LONG_T_KEYS)


def phase_long_t(root: Path, measure: bool = False):
    """The fused TAt and GTU past their old T caps through the CLI (the
    long-T path): :func:`write_long_t_project`, 2 epochs in
    float32 and 2 in bf16, the TAt, spatial and GTU launches checked per
    block, the float32 run's fused model against the unfused one (all three
    knobs off) on one test batch, and with ``measure`` (``--measure``) an
    epoch each for ms/step, its peak memory, device ms/step and the busy
    share (:func:`run_fused_cli`)."""
    return {dtype: run_fused_cli(root, write_long_t_project(root, dtype), f"long_t_cli_{dtype}",
                                 model_check=dtype == "float32", launches=LONG_T_LAUNCHES,
                                 knobs=("fuse_tat", "fuse_spatial", "fuse_gtu"), measure=measure)
            for dtype in ("float32", "bfloat16")}


# this slice's main paths: the fused TAt and spatial middle at head and
# channel widths the card refused before the kernels chunked them
WIDE_HEADS_KEYS = dict(n_heads=8, d_k=128, d_v=128, fuse_tat="true", fuse_spatial="true")
WIDE_CHANNELS_SIZES = (16, 8, 8)  # windows a split: 2 train steps of 8, 1 val, 1 test
WIDE_CHANNELS_KEYS = dict(d_model=4096, nb_chev_filter=512, nb_time_filter=512, n_heads=8,
                          d_k=128, d_v=128, batch_size=8, fuse_tat="true", fuse_spatial="true")


def write_wide_channels_project(root: Path, dtype: str) -> Path:
    """DSTAGNN at PEMS08 width (N = 170, T = 12, 4 blocks, K = 3) with
    nb_chev_filter = nb_time_filter = 512 (the GTU takes the conv's
    channels, so blocks 2-4 have C = Co = 512), d_model = 4096 and 8 heads
    of d_k = d_v = 128 (the SAt's d_k too), batch 8: :func:`synthetic_windows`
    and a seeded 8-nearest-neighbour graph as adjacency, STAG and STRG, with
    fuse_tat and fuse_spatial in ``dtype``."""
    name, N = f"WIDEC{dtype[0].upper()}", 170
    synthetic_windows(root, name, np.random.default_rng(19), N, 12, WIDE_CHANNELS_SIZES)
    adj = root / f"knn{N}.csv"
    if not adj.exists():
        write_dense_csv(adj, knn_adjacency(N))
    return write_project_conf(root, name, name, N, "PEMS08_WIDE", str(adj), str(adj), str(adj),
                              "G", compute_dtype=dtype, **WIDE_CHANNELS_KEYS)


def phase_wide_fused(root: Path):
    """The fused TAt and spatial middle past their old head and channel
    caps through the CLI: the wide_heads project (bench.py's GAMBIA
    configuration, :func:`write_gambia_project`, N = 2139, T = 144, 4
    features, batch 4, with 8 heads of d_k = d_v = 128) and the
    wide_channels one (:func:`write_wide_channels_project`), 2 epochs each
    in float32 and in bf16, with fuse_tat and fuse_spatial: the TAt and
    spatial launches checked per block, finite falling losses, and the
    float32 runs' fused model against the unfused one on one test batch
    (:func:`run_fused_cli`). Either project made the parent's Trainer or
    its first step raise."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        heads = write_gambia_project(root, f"WIDE_HEADS_{dtype}", dtype, **WIDE_HEADS_KEYS)
        out[f"wide_heads_{dtype}"] = run_fused_cli(root, heads, f"wide_heads_cli_{dtype}",
                                                   model_check=dtype == "float32", nb=2)
        out[f"wide_channels_{dtype}"] = run_fused_cli(
            root, write_wide_channels_project(root, dtype), f"wide_channels_cli_{dtype}",
            model_check=dtype == "float32")
    return out


def checkpoint_trainer(trainer, run_dir: Path):
    """The CLI's ``trainer`` with the run's last checkpoint's weights
    loaded (into its parameters, so its graphs stay), and that
    checkpoint's path."""
    from dstagnn_drought_tpu_torch.training import checkpoint as ckpt

    last = sorted(run_dir.glob("epoch_*.pt"))[-1]
    trainer.load_model_state(ckpt.restore_checkpoint(str(last), trainer.device)["model"])
    return trainer, last


def model_check_of(trainer, last: Path, knobs) -> dict:
    """One test batch in float32 through the checkpoint's model with the
    fused ``knobs`` on (those of the config; fuse_gtu as the Trainer
    resolved it) and off, within TOL of the output's scale (the two differ
    only in summation order)."""
    from dstagnn_drought_tpu_torch.training.step import eval_step

    x_full, y_full = trainer._splits["test"]
    bs = trainer.cfg.training.batch_size
    t = trainer.cfg.training
    on = dict(fuse_tat=t.fuse_tat, fuse_spatial=t.fuse_spatial, fuse_gtu=trainer.fuse_gtu)
    preds = {}
    for fused in (True, False):
        kw = on if fused else dict(on, **{k: False for k in knobs})
        preds[fused], _ = eval_step(trainer.model, x_full[:bs], y_full[:bs],
                                    trainer.constants, compute_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(preds[True], preds[False])
    check(rel <= TOL and bool(torch.isfinite(preds[True]).all()),
          f"fused vs unfused model at full width: {rel:.3g} of scale > {TOL}")
    return {"batch": bs, "knobs": list(knobs), "max_abs_err": err, "rel_err": rel, "tol": TOL,
            "checkpoint": last.name}


def measure_pems08_epochs(root: Path, rounds: int = 2):
    """Train-epoch time at PEMS08 width with the kernel and with the plain
    aggregation, alternated (plain, kernel, kernel, plain, ...)."""
    from dstagnn_drought_tpu_torch.config import load_config

    cfg = load_config(root / "SYNTH08.conf")
    trainers = {}
    for use in (False, True):
        c = load_config(root / "SYNTH08.conf")
        c.training.use_pallas = use
        trainers[use] = Trainer(c, experiments_root=str(root / f"measure_{use}"), device="cuda")
        trainers[use].train_epoch(0)  # warm-up
    times = {False: [], True: []}
    order = [False, True, True, False] * rounds
    for i, use in enumerate(order):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainers[use].train_epoch(i + 1)
        times[use].append((time.perf_counter() - t0) / trainers[use].last_epoch_steps * 1e3)
    out = {"path": "pems08_epoch_ms_per_step", "plain": times[False], "kernel": times[True],
           "batch_size": cfg.training.batch_size,
           "profile": {("kernel" if use else "plain"): profile_epoch(trainers[use])
                       for use in (True, False)}}
    print("measure", json.dumps(out), flush=True)
    return out


def profile_epoch(trainer, top: int = 12, eager: bool = False, shapes: bool = True):
    """torch.profiler over one training epoch (the eager loop with
    ``eager``; input shapes recorded with ``shapes``): device time by
    kernel name, by host op and by host op and input shapes, the
    device-busy share of the wall time, the launch count and the csrc
    kernels' launches by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (trainer.train_epoch_eager if eager else trainer.train_epoch)(1000)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3
    events = prof.key_averages()
    # device-side kernel records (not the device spans of record_function
    # regions, such as Optimizer.step's), and the host ops that launched them
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU and dev(e) > 0]
    busy_ms = sum(dev(e) for e in kernels)
    rank = lambda rows: [{"name": e.key[:90], "count": e.count, "device_ms": dev(e)}
                         for e in sorted(rows, key=dev, reverse=True)[:top]]
    # the host ops again, apart by their inputs' shapes: which product a
    # kernel of the ranking belongs to
    shaped = [e for e in prof.key_averages(group_by_input_shape=True)
              if e.device_type == torch.autograd.DeviceType.CPU and dev(e) > 0] if shapes else []
    by_shape = [{"name": e.key[:60], "shapes": str(e.input_shapes)[:160], "count": e.count,
                 "device_ms": dev(e)} for e in sorted(shaped, key=dev, reverse=True)[:top]]
    return {"steps": trainer.last_epoch_steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "device_ms_per_step": busy_ms / trainer.last_epoch_steps,
            "kernel_launches": sum(e.count for e in kernels),
            # the device spans of record_function regions, which earlier
            # versions of this function summed into the busy time
            "annotation_ms": sum(dev(e) for e in events
                                 if getattr(e, "is_user_annotation", False)),
            "csrc_kernels": csrc_kernel_counts(kernels),
            "top_ops": rank(ops), "top_ops_by_shape": by_shape, "top_kernels": rank(kernels)}


def csrc_kernels() -> dict:
    """{__global__ function name: its csrc file} of every hand-written kernel."""
    out = {}
    for f in sorted((REPO / "dstagnn_drought_tpu_torch" / "csrc").glob("*.cu*")):
        text = f.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            if text.startswith("__launch_bounds__", i):  # skip its (nested) parentheses
                depth, i = 0, text.index("(", i)
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            out[re.match(r"\s*(\w+)", text[i:]).group(1)] = f.name
    return out


def csrc_kernel_counts(kernels) -> dict:
    """{csrc kernel name: launches} of a profile's device kernel records."""
    names, out = csrc_kernels(), {}
    for e in kernels:
        mine = [w for w in re.findall(r"\w+_kernel\b", e.key) if w in names]
        if mine:
            out[mine[0]] = out.get(mine[0], 0) + e.count
    return out


FUSED_VARIANTS = {"unfused_plain": dict(use_pallas=False, fuse_tat=False, fuse_spatial=False),
                  "unfused_kernel": dict(use_pallas=True, fuse_tat=False, fuse_spatial=False),
                  "fused": dict(use_pallas=True, fuse_tat=True, fuse_spatial=True)}


def measure_fused_steps(root: Path, conf: Path, path: str, rounds: int = 2) -> dict:
    """Train-epoch time of the fused trainer of ``conf`` against the unfused
    one (plain aggregation, and the cheb_sat kernel), alternated in one
    process (plain, kernel, fused, fused, kernel, plain, ...), with each
    epoch's peak device memory (``epoch_peak``); then a profile of a fused
    epoch and of a plain one."""
    from dstagnn_drought_tpu_torch.config import load_config

    trainers = {}
    for name, keys in FUSED_VARIANTS.items():
        cfg = load_config(conf)
        for k, v in keys.items():
            setattr(cfg.training, k, v)
        trainers[name] = Trainer(cfg, experiments_root=str(root / f"m_{path}_{name}"),
                                 device="cuda")
        trainers[name].train_epoch(0)  # warm-up
    times = {name: [] for name in FUSED_VARIANTS}
    peak = {name: [] for name in FUSED_VARIANTS}
    order = ["unfused_plain", "unfused_kernel", "fused", "fused", "unfused_kernel",
             "unfused_plain"] * rounds
    for i, name in enumerate(order):
        ms, mib = epoch_peak(trainers[name], i + 1)
        times[name].append(ms)
        peak[name].append(mib)
    out = {"path": path, "batch_size": cfg.training.batch_size, **times,
           "epoch_peak_mib": peak,
           "profile": {name: profile_epoch(trainers[name]) for name in ("fused", "unfused_plain")}}
    print("measure", json.dumps(out), flush=True)
    del trainers
    torch.cuda.empty_cache()
    return out


def measure_pems07_fused(root: Path, rounds: int = 2) -> dict:
    """The PEMS07-width trainer, fused against both unfused ones, in float32
    and bf16 (:func:`measure_fused_steps`)."""
    return {dtype: measure_fused_steps(root, conf, f"pems07_{dtype}_fused_step_ms", rounds)
            for dtype, conf in pems07_fused_projects(root).items()}


def measure_accuracy(root: Path, epochs: int = 25):
    """The accuracy schedule of benchmarks/accuracy_parity.py at PEMS08
    width (25 epochs, Adam 1e-4, batch 64, seed 2024) with the plain and the
    kernel aggregation, beside the reference model's recorded run on the
    same dataset (benchmarks/parity_runs/result_ref.json)."""
    from dstagnn_drought_tpu_torch.config import load_config

    ref = json.loads((REPO / "benchmarks" / "parity_runs" / "result_ref.json").read_text())
    out = {"path": "pems08_accuracy", "epochs": epochs,
           "reference": {"side": ref["side"], **ref["report"]["overall"]}}
    for use in (False, True):
        cfg = load_config(root / "SYNTH08.conf")
        cfg.training.use_pallas = use
        trainer = Trainer(cfg, experiments_root=str(root / f"accuracy_{use}"), device="cuda")
        t0 = time.perf_counter()
        result = trainer.run(epochs)
        out["kernel" if use else "plain"] = {
            **result["report"]["overall"], "best_epoch": result["best_epoch"],
            "wall_s": time.perf_counter() - t0}
    print("measure", json.dumps(out), flush=True)
    for side in ("plain", "kernel"):
        check(out[side]["mae"] <= 1.25 * out["reference"]["mae"],
              f"{side} {epochs}-epoch test MAE {out[side]['mae']:.2f} vs reference "
              f"{out['reference']['mae']:.2f}")
    return out


# ---------------------------------------------------------------------------
# phase 4: GAMBIA dense
# ---------------------------------------------------------------------------

GAMBIA_NX, GAMBIA_NY, GAMBIA_F, GAMBIA_T_IN, GAMBIA_T_PRED = 93, 23, 4, 144, 12


def gambia_data(seed: int = 0, n_train: int = 12, n_eval: int = 4):
    """A drought-like (T, N, F) field on a 93×23 grid (N=2139) with its
    4-neighbour adjacency and a 1%-dense STRG, windowed T=144 → 12."""
    rng = np.random.default_rng(seed)
    nx, ny, F = GAMBIA_NX, GAMBIA_NY, GAMBIA_F
    N = nx * ny
    n_win = n_train + 2 * n_eval
    t_total = GAMBIA_T_IN + GAMBIA_T_PRED + n_win - 1
    gx = np.repeat(np.arange(nx), ny)
    t = np.arange(t_total)[:, None]
    season = np.sin(2 * np.pi * t / 12.0 + gx[None, :] / nx * 2)
    sig = np.empty((t_total, N, F), np.float32)
    for f in range(F):
        noise = rng.normal(size=(t_total, N)).astype(np.float32) * 0.3
        sig[..., f] = 10 + 3 * season * (0.5 + 0.5 * f / F) + noise
    A = grid_adjacency(nx, ny)
    pa = (rng.random((N, N)) < 0.01).astype(np.float32)
    np.fill_diagonal(pa, 1)
    xs = np.stack([sig[s:s + GAMBIA_T_IN] for s in range(n_win)]).transpose(0, 2, 3, 1)
    ys = np.stack([sig[s + GAMBIA_T_IN:s + GAMBIA_T_IN + GAMBIA_T_PRED, :, 0]
                   for s in range(n_win)]).transpose(0, 2, 1)
    mean = xs[:n_train].mean(axis=(0, 1, 3), keepdims=True)
    std = xs[:n_train].std(axis=(0, 1, 3), keepdims=True)
    xs = ((xs - mean) / std).astype(np.float32)
    ys = ys.astype(np.float32)
    cut = (n_train, n_train + n_eval)
    ds = ArrayDataset(
        train=Split(xs[:cut[0]], ys[:cut[0]]),
        val=Split(xs[cut[0]:cut[1]], ys[cut[0]:cut[1]]),
        test=Split(xs[cut[1]:], ys[cut[1]:]), mean=mean, std=std,
    )
    return ds, A, pa


def gambia_config(N: int, use_pallas: bool = True, **keys) -> Config:
    """The GAMBIA configuration of bench.py:222-236 (bf16); ``keys`` adds
    or replaces training keys: the BELL keys (sparse, sparse_format,
    mask_format, rcm, block_size), fuse_gtu, compute_dtype."""
    return Config(
        data=DataConfig(num_of_vertices=N, len_input=GAMBIA_T_IN,
                        num_for_predict=GAMBIA_T_PRED, dataset_name="GAMBIA_SYN",
                        points_per_hour=12),
        training=TrainingConfig(
            in_channels=GAMBIA_F, nb_block=2, n_heads=2, K=2, d_k=32, d_model=64,
            nb_chev_filter=32, nb_time_filter=32, batch_size=4, learning_rate=1e-4,
            num_of_hours=12, use_pallas=use_pallas, **{"compute_dtype": "bfloat16", **keys},
        ),
    ).validate()


def phase_gambia(root: Path):
    ds, A, pa = gambia_data()
    N = A.shape[0]
    cfg = gambia_config(N)
    trainer = Trainer(cfg, dataset=ds, adj_merge=A, adj_pa=pa,
                      experiments_root=str(root / "gambia"), device="cuda")
    reset_launches()
    loss0 = trainer.train_epoch(0)
    steps = trainer.last_epoch_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1 = trainer.train_epoch(1)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / trainer.last_epoch_steps * 1e3
    launches = launches_run(read_launches(), [trainer])["cheb_sat"]
    check(steps == 3, f"expected 3 GAMBIA steps per epoch, got {steps}")
    check(math.isfinite(loss0) and math.isfinite(loss1), f"GAMBIA losses {loss0}, {loss1}")
    check(launches == 2 * steps * cfg.training.nb_block,
          f"GAMBIA cheb_sat launches {launches} != {2 * steps} steps x 2 blocks")
    out = {"path": "gambia_dense_bf16", "device": torch.cuda.get_device_name(0),
           "N": N, "train_losses": [loss0, loss1],
           "launches": launches, "steps": 2 * steps, "ms_per_step_epoch2": ms_step,
           "graphs": graph_summary(trainer)}
    print("main_path", json.dumps(out), flush=True)
    return out


def measure_gambia_steps(root: Path, rounds: int = 2):
    """GAMBIA dense bf16 train-step time with the kernel and with the plain
    aggregation, alternated, then a profile of the kernel path."""
    ds, A, pa = gambia_data()
    trainers = {}
    for use in (False, True):
        trainers[use] = Trainer(gambia_config(A.shape[0], use), dataset=ds,
                                adj_merge=A, adj_pa=pa,
                                experiments_root=str(root / f"gambia_{use}"), device="cuda")
        trainers[use].train_epoch(0)  # warm-up
    times = {False: [], True: []}
    for i, use in enumerate([False, True, True, False] * rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainers[use].train_epoch(i + 1)
        times[use].append((time.perf_counter() - t0) / trainers[use].last_epoch_steps * 1e3)
    out = {"path": "gambia_step_ms", "plain": times[False], "kernel": times[True],
           "profile": {"kernel": profile_epoch(trainers[True])}}
    print("measure", json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 5-6: GAMBIA block-sparse (BELL)
# ---------------------------------------------------------------------------

BELL_TILES = dict(sparse=True, sparse_format="bell", mask_format="tiles", block_size=128)
BELL_DENSE_RCM = dict(sparse=True, sparse_format="bell", rcm=True, block_size=128)




def run_gambia(root: Path, name: str, epochs: int, adj=None, **keys):
    """Trainer.run at the GAMBIA config (``keys`` add training keys: the
    BELL or ELL keys, fuse_gtu; ``adj`` replaces the grid graph), with every
    launch count set to 0 just before and read just after. Checks finite
    losses, a checkpoint and the test dump. Returns (trainer, dataset,
    summary with the launches, forward passes and train steps)."""
    ds, A, pa = gambia_data()
    A = A if adj is None else adj
    N = A.shape[0]
    trainer = Trainer(gambia_config(N, **keys), dataset=ds, adj_merge=A, adj_pa=pa,
                      experiments_root=str(root / name), device="cuda")
    bs = trainer.cfg.training.batch_size
    batches = {s: -(-len(getattr(ds, s)) // bs) for s in ("train", "val", "test")}
    reset_launches()
    result = trainer.run(epochs)
    torch.cuda.synchronize()
    launches = launches_run(read_launches(), [trainer])
    forwards = epochs * (batches["train"] + batches["val"]) + batches["test"]
    steps = epochs * batches["train"]
    events = [json.loads(line) for line in
              (Path(trainer.run_dir) / "metrics.jsonl").read_text().splitlines()]
    ep = [e for e in events if e["event"] == "epoch"]
    losses = [e["train_loss"] for e in ep] + [e["val_loss"] for e in ep]
    check(len(ep) == epochs and all(math.isfinite(v) for v in losses),
          f"{name}: losses {losses}")
    check(math.isfinite(result["test_loss"]), f"{name}: test loss {result['test_loss']}")
    check(any(Path(trainer.run_dir).glob("epoch_*.pt")), f"{name}: no checkpoint")
    check(len(list(Path(trainer.run_dir).glob("output_epoch_*_test.npz"))) == 1,
          f"{name}: no test prediction dump")
    out = {"path": name, "device": torch.cuda.get_device_name(0), "N": N,
           "train_losses": [e["train_loss"] for e in ep],
           "val_losses": [e["val_loss"] for e in ep], "test_loss": result["test_loss"],
           "test_overall": result["report"]["overall"], "launches": launches,
           "forward_passes": forwards, "train_steps": steps,
           "ms_per_step_last_epoch": ep[-1]["train_seconds"] / ep[-1]["steps"] * 1e3,
           "graphs": graph_summary(trainer)}
    if "bell" in trainer.constants:
        out["active_tiles"] = trainer.constants["bell"].num_active
        out["slots"] = trainer.constants["bell"].max_blocks
    return trainer, ds, out


def check_launches(out: dict, per_forward=(), per_step=(), never=(), nb: int = 2) -> None:
    """Each kernel in ``per_forward`` launched once per block of every
    forward pass, each in ``per_step`` once per block of every train step,
    each in ``never`` not at all."""
    got, name = out["launches"], out["path"]
    for k, unit in [(k, "forward_passes") for k in per_forward] + \
                   [(k, "train_steps") for k in per_step]:
        check(got[k] == out[unit] * nb,
              f"{name}: {k} launches {got[k]} != {out[unit]} {unit} x {nb} blocks")
    for k in never:
        check(got[k] == 0, f"{name}: {k} ran {got[k]} times")


BELL_LAUNCHES = dict(per_forward=("bell_fused",), per_step=("bell_k1", "bell_k2"))


def phase_gambia_bell_tiles(root: Path):
    """The main path of the BELL slice: bench.py's GAMBIA bell_tiles
    configuration, 2 epochs of 3 steps through the Trainer."""
    _, _, out = run_gambia(root, "gambia_bell_tiles", 2, **BELL_TILES)
    check_launches(out, **BELL_LAUNCHES, never=("cheb_sat", "gtu_fwd", "gtu_bwd"))
    print("main_path", json.dumps(out), flush=True)
    return out


def phase_gambia_bell_rcm(root: Path):
    """GAMBIA BELL with dense masks (the fused kernel with the plane
    wrapper) and rcm=true, one epoch; then the test predictions against
    those of an unpermuted BELL trainer carrying the same weights in the
    original node order: they must agree node for node."""
    trainer, ds, out = run_gambia(root, "gambia_bell_rcm", 1, **BELL_DENSE_RCM)
    check_launches(out, **BELL_LAUNCHES, never=("cheb_sat", "gtu_fwd", "gtu_bwd"))
    perm, inv = trainer._perm, trainer._inv_perm
    check(not np.array_equal(perm, np.arange(len(perm))), "rcm permutation is the identity")
    dump = next(Path(trainer.run_dir).glob("output_epoch_*_test.npz"))
    with np.load(dump) as d:
        pred, target = d["prediction"], d["data_target_tensor"]
    check(pred.shape == ds.test.target.shape and bool(np.isfinite(pred).all()),
          f"rcm test predictions {pred.shape}")
    check(np.array_equal(target, ds.test.target), "rcm dump targets not in the original order")
    _, A, pa = gambia_data()
    sparse = {**BELL_DENSE_RCM, "rcm": False}
    ref = Trainer(gambia_config(A.shape[0], **sparse), dataset=ds, adj_merge=A, adj_pa=pa,
                  experiments_root=str(root / "gambia_bell_ref"), device="cuda")
    ref.model.load_state_dict(permute_nodes(trainer.model.state_dict(), inv))
    ref.constants["cheb_polys"] = trainer.constants["cheb_polys"][:, inv][:, :, inv]
    # compared in float32, where the two tilings differ only in summation order
    ref.compute_dtype = trainer.compute_dtype = torch.float32
    pred_ref, _ = ref.evaluate("test")
    pred_rcm, _ = trainer.evaluate("test")
    scale = max(1.0, float(np.abs(pred_ref).max()))
    err = float(np.abs(pred_rcm - pred_ref).max()) / scale
    err_unmapped = float(np.abs(pred_rcm[:, perm] - pred_ref).max()) / scale
    mae = float(np.abs(pred_rcm - ds.test.target).mean())
    out.update(order_rel_err_f32=err, order_rel_err_if_unmapped=err_unmapped, test_mae_f32=mae)
    print("main_path", json.dumps(out), flush=True)
    check(err <= TOL, f"rcm predictions vs the unpermuted model: {err:.3g} > {TOL}")
    return out


# the full-width BELL path: bench.py's GAMBIA BELL-tiles configuration with
# nb_chev_filter = 128 (and the GTU's nb_time_filter with it: the GTU takes
# the conv's channels), so block 2's conv has C = Co = 128 (M = C·T = 18,432)
WIDE_CHEV = 128


def write_gambia_project(root: Path, name: str, dtype: str, **training) -> Path:
    """gambia_data's windows (N = 2139, F = 4, T = 144 → 12) as a
    reference-format project for the training CLI: the windowed npz, the
    grid graph as a dense adjacency (graph = G) and STAG CSV, the STRG CSV,
    and the GAMBIA configuration of bench.py:222-236 (gambia_config's keys,
    2 epochs) in ``dtype`` with ``training``'s keys over it."""
    ds, A, pa = gambia_data()
    data = root / "GAMBIA_r12_d0_w0_dstagnn.npz"
    if not data.exists():
        np.savez(data, **{f"{s}_x": getattr(ds, s).x for s in ("train", "val", "test")},
                 **{f"{s}_target": getattr(ds, s).target for s in ("train", "val", "test")},
                 mean=ds.mean, std=ds.std)
        write_dense_csv(root / "gambia_adj.csv", A)
        write_dense_csv(root / "gambia_strg.csv", pa)
    t = gambia_config(A.shape[0]).training
    keys = {k: getattr(t, k) for k in (
        "in_channels", "nb_block", "n_heads", "K", "d_k", "d_model", "nb_chev_filter",
        "nb_time_filter", "batch_size", "learning_rate")}
    keys.update(epochs=2, use_pallas="true", compute_dtype=dtype, **training)
    body = "\n".join(f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
                     for k, v in keys.items())
    conf = root / f"{name}.conf"
    conf.write_text(f"""[Data]
adj_filename = {root}/gambia_adj.csv
graph_signal_matrix_filename = {root}/GAMBIA.npz
stag_filename = {root}/gambia_adj.csv
strg_filename = {root}/gambia_strg.csv
num_of_vertices = {A.shape[0]}
points_per_hour = 12
num_for_predict = {GAMBIA_T_PRED}
len_input = {GAMBIA_T_IN}
dataset_name = GAMBIA_SYN

[Training]
model_name = dstagnn
graph = G
num_of_hours = 12
num_of_days = 0
num_of_weeks = 0
{body}
""")
    return conf


def bell_plain_check(trainer, last: Path) -> dict:
    """One test batch in float32 through the checkpoint's model with the
    BELL forward kernel and with its plain version in its place (the same
    weights), within TOL of the output's scale; the kernel launched once a
    block and the plain pass launching none."""
    from dstagnn_drought_tpu_torch.training.step import eval_step

    x_full, y_full = trainer._splits["test"]
    bs, nb = trainer.cfg.training.batch_size, trainer.cfg.training.nb_block
    kernel, preds, counts = bell_fused.bell_forward, {}, {}
    for plain in (False, True):
        if plain:
            bell_fused.bell_forward = bell_fused.bell_forward_plain
        before = bell_fused.launches
        try:
            preds[plain], _ = eval_step(trainer.model, x_full[:bs], y_full[:bs],
                                        trainer.constants, compute_dtype=torch.float32)
        finally:
            bell_fused.bell_forward = kernel
        torch.cuda.synchronize()
        counts[plain] = bell_fused.launches - before
    err, rel = rel_err(preds[False], preds[True])
    check(counts == {False: nb, True: 0}, f"BELL forward launches in the model check: {counts}")
    check(rel <= TOL and bool(torch.isfinite(preds[False]).all()),
          f"BELL kernels vs their plain versions at full width: {rel:.3g} of scale > {TOL}")
    return {"batch": bs, "max_abs_err": err, "rel_err": rel, "tol": TOL,
            "checkpoint": last.name, "launches": counts[False]}


def phase_gambia_wide(root: Path):
    """This slice's full-width path: the training CLI at bench.py's GAMBIA
    BELL-tiles configuration with nb_chev_filter = nb_time_filter = 128
    (block 2's conv at C = Co = 128), 2 epochs of 3 steps in float32 and 2 in bf16: finite,
    falling losses, a checkpoint and the report (run_pems08_cli), F once a
    block of every forward pass and K1, K2 once a block of every train step;
    the float32 run's last checkpoint on one test batch against the same
    weights through the plain versions (bell_plain_check); then one epoch
    of each run's checkpoint for ms/step and its peak memory, and a
    profiled one for device ms/step and the busy share."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        conf = write_gambia_project(root, f"GAMBIA_WIDE_{dtype}", dtype,
                                    nb_chev_filter=WIDE_CHEV, nb_time_filter=WIDE_CHEV,
                                    **BELL_TILES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run, counts, _, trainer, run_dir = run_pems08_cli(root, conf,
                                                          root / f"exp_wide_{dtype}")
        res = {"path": f"gambia_bell_tiles_c{WIDE_CHEV}_cli_{dtype}", **run, "launches": counts,
               "run_peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
               "cli_seconds": time.perf_counter() - t0}
        check_launches(res, **BELL_LAUNCHES, never=("cheb_sat", "gtu_fwd", "gtu_bwd"))
        trainer, last = checkpoint_trainer(trainer, run_dir)
        if dtype == "float32":
            res["plain_check"] = bell_plain_check(trainer, last)
        ms, peak = epoch_peak(trainer, 0)
        prof = profile_epoch(trainer, top=8)
        res["epoch"] = {"ms_per_step": ms, "epoch_peak_mib": peak,
                        "device_ms_per_step": prof["device_ms_per_step"],
                        "busy_share": prof["busy_share"], "steps": prof["steps"],
                        "top_kernels": prof["top_kernels"]}
        del trainer
        torch.cuda.empty_cache()
        print("main_path", json.dumps(res), flush=True)
        out[dtype] = res
    return out


def measure_gambia_bell(root: Path, rounds: int = 2):
    """GAMBIA train-step time of the BELL tiles path against the dense path
    with the cheb_sat kernel and with the plain aggregation (bench.py's
    comparison), alternated in one process; then a profile of the BELL
    step."""
    ds, A, pa = gambia_data()
    configs = {"dense_plain": dict(use_pallas=False), "dense_kernel": dict(use_pallas=True),
               "bell_tiles": BELL_TILES}
    trainers = {}
    for name, kw in configs.items():
        trainers[name] = Trainer(gambia_config(A.shape[0], **kw), dataset=ds, adj_merge=A,
                                 adj_pa=pa, experiments_root=str(root / f"m_{name}"),
                                 device="cuda")
        trainers[name].train_epoch(0)  # warm-up
    times = {name: [] for name in configs}
    order = ["dense_plain", "dense_kernel", "bell_tiles", "bell_tiles", "dense_kernel",
             "dense_plain"] * rounds
    for i, name in enumerate(order):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainers[name].train_epoch(i + 1)
        times[name].append((time.perf_counter() - t0) / trainers[name].last_epoch_steps * 1e3)
    out = {"path": "gambia_bell_step_ms", **times,
           "profile": {"bell_tiles": profile_epoch(trainers["bell_tiles"])}}
    print("measure", json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: STAG construction on the card
# ---------------------------------------------------------------------------

STAG_T = 287          # GAMBIA's monthly steps (benchmarks/gambia_bench.py:7-9)
STAG_NODES = 128      # the Sinkhorn run's nodes: 8,128 pairs, two blocks of 4096
STAG_SUBSET = 8       # the nodes whose Sinkhorn result the CPU run checks (28 pairs)
# card against the port's own CPU run of the same float32 ops, relative to
# the largest distance: the log-sum-exp reductions and exp run in another
# order and implementation over 200 iterations; the float32 result itself
# sits 6.1e-6 of scale from a float64 run of the same code (CPU, 8 nodes)
STAG_CPU_TOL = 1e-4


def synth_drought(seed: int = 0):
    """The numpy recipe of benchmarks/gambia_bench.py:synth_drought: a
    (T=287, N=2139, F=4) smooth seasonal field with spatially smoothed
    anomalies on the 93×23 grid, and its (N, 2) grid coordinates."""
    rng = np.random.default_rng(seed)
    nx, ny, F = GAMBIA_NX, GAMBIA_NY, GAMBIA_F
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    t = np.arange(STAG_T)[:, None]
    season = np.sin(2 * np.pi * t / 12.0 + coords[None, :, 0] / nx * 2)
    out = np.empty((STAG_T, nx * ny, F), np.float32)
    for f in range(F):
        a = rng.normal(size=(STAG_T, nx * ny)).astype(np.float32) * 0.3
        a = a.reshape(STAG_T, nx, ny)
        a = (a + np.roll(a, 1, 1) + np.roll(a, -1, 1)
             + np.roll(a, 1, 2) + np.roll(a, -1, 2)) / 5.0
        out[..., f] = 10 + 3 * season * (0.5 + 0.5 * f / F) + a.reshape(STAG_T, nx * ny)
    return out, coords


def check_sta(name: str, sta: np.ndarray, hi: float) -> None:
    """Finite, symmetric, zero diagonal, in [0, hi] (1e-6 of slack for the
    float32 sums)."""
    check(bool(np.isfinite(sta).all()), f"{name}: non-finite entries")
    check(np.array_equal(sta, sta.T), f"{name}: not symmetric")
    check(bool(np.all(np.diag(sta) == 0)), f"{name}: non-zero diagonal")
    check(float(sta.min()) >= -1e-6 and float(sta.max()) <= hi + 1e-6,
          f"{name}: entries outside [0, {hi}]: {sta.min()}, {sta.max()}")


def phase_stag(root: Path):
    """STAG construction on the card at GAMBIA's shapes (T=287, F=4): the
    fast PCA variant at full N=2139; the Sinkhorn STAG (200 iterations,
    blocks of 4096 pairs) of the first 128 nodes through the stag_gen CLI,
    its CSVs read back by the port's loaders; its first STAG_SUBSET nodes
    held against the port's own CPU run."""
    sig, coords = synth_drought()
    N = sig.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast = fast_sta_matrix(sig, coords, device="cuda")
    fast_s = time.perf_counter() - t0
    check_sta("fast_sta_matrix", fast, 2.0)  # cosine distance: [0, 2]
    check(int((fast > 0).sum()) > 0, "fast_sta_matrix: no pair within the cutoff")

    sub = sig[:, :STAG_NODES]
    np.savez(root / "GAMBIA128.npz", data=sub)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sta, A, R, (a_path, r_path) = stag_gen.main([
        "--input", str(root / "GAMBIA128.npz"), "--dataset", "GAMBIA128",
        "--out-dir", str(root / "stag"), "--iters", "200", "--block-size", "4096",
        "--device", "cuda"])
    torch.cuda.synchronize()
    sink_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    pairs = STAG_NODES * (STAG_NODES - 1) // 2
    check_sta("sta_matrix", sta, 1.0)
    check(np.array_equal(load_stag_adjacency(a_path, STAG_NODES), A),
          "stag CSV read back differs")
    check(np.array_equal(load_strg_adjacency(r_path), (R > 0).astype(np.float64)),
          "strg CSV read back differs")

    sub_n = sig[:, :STAG_SUBSET]
    kw = dict(num_iters=200, block_size=STAG_SUBSET * (STAG_SUBSET - 1) // 2)
    card_n = sta_matrix(sub_n, device="cuda", **kw)
    t0 = time.perf_counter()
    cpu_n = sta_matrix(sub_n, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(cpu_n).max())
    err = float(np.abs(card_n - cpu_n).max()) / scale
    in_blocks = float(np.abs(card_n - sta[:STAG_SUBSET, :STAG_SUBSET]).max()) / scale
    out = {"path": "stag", "device": torch.cuda.get_device_name(0), "T": STAG_T,
           "F": sig.shape[2], "fast_N": N, "fast_seconds": fast_s,
           "fast_nonzero_pairs": int((np.triu(fast, 1) > 0).sum()),
           "sinkhorn_nodes": STAG_NODES, "sinkhorn_pairs": pairs, "iters": 200,
           "block_size": 4096, "sinkhorn_seconds_cli": sink_s,
           "pairs_per_s": pairs / sink_s, "peak_mib": peak,
           "sta_range": [float(sta[np.triu_indices(STAG_NODES, 1)].min()), float(sta.max())],
           "edges_per_row": float(A.sum(1).mean()),
           "card_vs_cpu_rel_err": err, "card_vs_cpu_tol": STAG_CPU_TOL,
           "cpu_subset_seconds": cpu_s, "subset_vs_128_node_blocks": in_blocks}
    print("graph_pipeline", json.dumps(out), flush=True)
    check(err <= STAG_CPU_TOL, f"Sinkhorn card vs CPU: {err:.3g} of scale > {STAG_CPU_TOL}")
    return out


def measure_stag_full():
    """The Sinkhorn STAG of all 2,286,591 GAMBIA pairs (T=287, F=4, 200
    iterations, blocks of 4096) on the card: seconds, pairs/s, peak memory."""
    sig, _ = synth_drought()
    N = sig.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sta = sta_matrix(sig, num_iters=200, block_size=4096, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_sta("sta_matrix (full)", sta, 1.0)
    pairs = N * (N - 1) // 2
    out = {"path": "stag_full", "device": torch.cuda.get_device_name(0), "N": N,
           "pairs": pairs, "seconds": seconds, "pairs_per_s": pairs / seconds,
           "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2 ** 20}
    print("measure", json.dumps(out), flush=True)
    return out


def profile_sinkhorn_block(iters: int = 200, top: int = 8):
    """torch.profiler over one Sinkhorn block of 4096 GAMBIA pairs (T=287,
    F=4): device time by kernel, the busy share, and the block's time."""
    from torch.profiler import ProfilerActivity, profile

    from dstagnn_drought_tpu_torch.data import stag

    sig, _ = synth_drought()
    marg, xn = stag._marginals_and_normed(torch.as_tensor(sig, device="cuda"))
    iu, ju = np.triu_indices(sig.shape[1], k=1)
    ii = torch.as_tensor(iu[:4096], device="cuda")
    jj = torch.as_tensor(ju[:4096], device="cuda")
    stag._pair_block_distances(marg, xn, ii, jj, 0.01, 2)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stag._pair_block_distances(marg, xn, ii, jj, 0.01, iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev(e) for e in kernels)
    out = {"path": "sinkhorn_block_profile", "device": torch.cuda.get_device_name(0),
           "pairs": 4096, "iters": iters, "wall_ms": wall_ms, "device_busy_ms": busy,
           "busy_share": busy / wall_ms,
           "top_kernels": [{"name": e.key[:90], "count": e.count, "device_ms": dev(e)}
                           for e in sorted(kernels, key=dev, reverse=True)[:top]]}
    print("measure", json.dumps(out), flush=True)
    return out


def measure_graph_pipeline(root: Path):
    """The Sinkhorn block's profile, and an epoch profile of the GAMBIA ELL
    trainer on the grid graph and on the 1%-random graph."""
    out = {"sinkhorn_block": profile_sinkhorn_block()}
    for name, adj in (("grid", None),
                      ("random", random_adjacency(GAMBIA_NX * GAMBIA_NY, 0.01, 1))):
        trainer, _, _ = run_gambia(root, f"m_ell_{name}", 1, adj=adj, **ELL_KEYS)
        out[f"ell_{name}"] = profile_epoch(trainer)
    print("measure", json.dumps({"path": "ell_epoch_profiles",
                                 **{k: v for k, v in out.items() if k.startswith("ell")}}),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the GAMBIA ELL trainer
# ---------------------------------------------------------------------------

ELL_KEYS = dict(sparse=True, sparse_format="ell")
NO_KERNEL = tuple(read_launches())


def record_ell_branches():
    """Wrap the two ELL aggregation branches so that each call records its
    (C·T, gather bytes, branch); returns the record list and an undo."""
    calls, real = [], (sparse._gather_aggregate, sparse._slot_loop_aggregate)

    def wrap(fn, branch):
        def run(A, xm, ell):
            calls.append((xm.shape[-1], sparse.edge_gather_bytes(xm, ell), branch))
            return fn(A, xm, ell)
        return run

    sparse._gather_aggregate = wrap(real[0], "gather")
    sparse._slot_loop_aggregate = wrap(real[1], "slot_loop")

    def undo():
        sparse._gather_aggregate, sparse._slot_loop_aggregate = real
    return calls, undo


def ell_blocks(calls: list, nb: int = 2) -> list:
    """Per block (by C·T, in block order): its gather bytes, the limit and
    the branches its calls took."""
    out = []
    for ct in sorted({c[0] for c in calls}):
        mine = [c for c in calls if c[0] == ct]
        out.append({"CT": ct, "gather_bytes": mine[0][1],
                    "limit_bytes": sparse._GATHER_BYTES_LIMIT,
                    "branches": sorted({c[2] for c in mine}), "calls": len(mine)})
    check(len(out) == nb, f"ELL aggregation at {len(out)} widths, expected {nb} blocks")
    return out


def pool_free_mib(trainer) -> float:
    """MiB that the trainer's CUDA graph pool holds free between replays:
    the replays' activations and temporaries, which a replay writes without
    allocating (the allocator's peak does not see them)."""
    if not trainer.graph_stats:
        return 0.0
    pool = tuple(trainer.runners()[0].pool)
    return sum(b["size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool
               for b in seg["blocks"] if b["state"] == "inactive") / 2 ** 20


def epoch_peak(trainer, epoch: int) -> tuple[float, float]:
    """(ms/step, peak MiB above what was allocated before) of one epoch;
    for a graphed trainer whose graphs were captured before the epoch, the
    peak adds the free bytes of its graph pool (:func:`pool_free_mib`)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train_epoch(epoch)
    ms = (time.perf_counter() - t0) / trainer.last_epoch_steps * 1e3
    return ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 20 + pool_free_mib(trainer)


def phase_gambia_ell(root: Path):
    """The ELL trainer at the GAMBIA configuration (bf16, B=4, nb_block=2,
    T=144→12): Trainer.run for 2 epochs of 3 steps on the grid graph (E=5),
    falling losses and no kernel launched (ELL is torch ops; use_pallas is
    ignored on it); block 1 takes the one-shot gather, block 2 the slot
    loop. Then one epoch on the 1%-random N=2139 graph of phase 2b."""
    calls, undo = record_ell_branches()
    try:
        trainer, _, out = run_gambia(root, "gambia_ell", 2, **ELL_KEYS)
        blocks = ell_blocks(calls)
        ms, peak = epoch_peak(trainer, 2)
        calls.clear()
        rnd, _, rnd_out = run_gambia(root, "gambia_ell_random", 1,
                                     adj=random_adjacency(GAMBIA_NX * GAMBIA_NY, 0.01, 1),
                                     **ELL_KEYS)
        rnd_blocks = ell_blocks(calls)
        rnd_ms, rnd_peak = epoch_peak(rnd, 1)
    finally:
        undo()
    check_launches(out, never=NO_KERNEL)
    check_launches(rnd_out, never=NO_KERNEL)
    losses = out["train_losses"]
    check(losses[1] < losses[0], f"gambia_ell: epoch-2 loss {losses[1]} not below {losses[0]}")
    check([b["branches"] for b in blocks] == [["gather"], ["slot_loop"]],
          f"gambia_ell branches {blocks}")
    out.update(E=trainer.constants["ell"].max_degree, blocks=blocks,
               ms_per_step_epoch3=ms, epoch_peak_mib=peak,
               random_graph={"E": rnd.constants["ell"].max_degree,
                             "edges": rnd.constants["ell"].num_edges,
                             "train_losses": rnd_out["train_losses"],
                             "test_loss": rnd_out["test_loss"], "blocks": rnd_blocks,
                             "ms_per_step_epoch2": rnd_ms, "epoch_peak_mib": rnd_peak})
    print("graph_pipeline", json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the model zoo at PEMS08 width
# ---------------------------------------------------------------------------

ZOO = ("astgcn", "mstgcn", "stgcn", "transformer")
ZOO_BF16 = ("astgcn", "transformer")  # the families whose softmaxes run in bf16
ZOO_CHECK_WINDOWS = 16  # test windows of the card-vs-CPU check (the CPU side takes its time)


def zoo_model_check(trainer, run_dir: Path):
    """The CLI's ``trainer``: float32, full width, the run's last checkpoint, the first
    ZOO_CHECK_WINDOWS windows of one test batch: the card's predictions
    against the same weights on the CPU, within TOL of the output's scale
    (TF32 off). Returns (the check, the Trainer with those weights on the
    card)."""
    import copy

    from dstagnn_drought_tpu_torch.training.step import eval_step

    trainer, last = checkpoint_trainer(trainer, run_dir)
    bs = min(trainer.cfg.training.batch_size, ZOO_CHECK_WINDOWS)
    x, y = (s[:bs] for s in trainer._splits["test"])
    pred, _ = eval_step(trainer.model, x, y, trainer.constants)
    torch.cuda.synchronize()
    cpu = {k: v.cpu() for k, v in trainer.constants.items()}
    t0 = time.perf_counter()
    want, _ = eval_step(copy.deepcopy(trainer.model).cpu(), x.cpu(), y.cpu(), cpu)
    cpu_s = time.perf_counter() - t0
    err, rel = rel_err(pred.cpu(), want)
    check(rel <= TOL and bool(torch.isfinite(pred).all()),
          f"{trainer.cfg.training.model_name}: card vs CPU {rel:.3g} of scale > {TOL}")
    return {"batch": bs, "max_abs_err": err, "rel_err": rel, "tol": TOL,
            "checkpoint": last.name, "cpu_seconds": cpu_s}, trainer


def phase_zoo(root: Path, measure: bool = False):
    """The model zoo's main path: for each family, the training CLI for 2
    epochs at PEMS08 width (float32, use_pallas left on: the families have
    no kernel, so every launch count must read 0), then the card against the
    CPU on one test batch and, with ``measure`` (``--measure``), one more
    epoch for ms/step and epoch peak memory and one profiled epoch for the
    device-busy share; then one bf16 epoch of each family whose softmaxes
    run in bf16 (finite losses)."""
    out = []
    runs = [(name, "float32", 2) for name in ZOO] + [(name, "bfloat16", 1) for name in ZOO_BF16]
    for name, dtype, epochs in runs:
        t0 = time.perf_counter()
        conf = write_pems08_project(root, f"SYNTH08_{name}_{dtype}", model_name=name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        args = ["--bfloat16"] if dtype == "bfloat16" else []
        run, launches, _, trainer, run_dir = run_pems08_cli(
            root, conf, root / f"exp_zoo_{name}_{dtype}", args, epochs=epochs)
        run_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        check(all(v == 0 for v in launches.values()), f"{name}: kernels launched {launches}")
        line = {"family": name, "dtype": dtype, **run, "launches": launches,
                "run_peak_mib": run_peak, "cli_seconds": time.perf_counter() - t0}
        if epochs == 2:
            line["model_check"], trainer = zoo_model_check(trainer, run_dir)
            if measure:
                line["ms_per_step_epoch3"], line["epoch_peak_mib"] = epoch_peak(trainer, 2)
                prof = profile_epoch(trainer, top=5)
                line["profile"] = {k: prof[k] for k in ("busy_share", "device_ms_per_step",
                                                        "kernel_launches", "top_ops")}
        del trainer
        line["seconds"] = time.perf_counter() - t0
        print("zoo", json.dumps(line), flush=True)
        out.append(line)
    return out


# ---------------------------------------------------------------------------
# phases 4b and 5b: the fused GTU tail at the GAMBIA config
# ---------------------------------------------------------------------------

def phase_gambia_fuse_gtu(root: Path):
    """The main path of the GTU slice: GAMBIA dense (bf16, use_pallas) with
    fuse_gtu = true, Trainer.run for 2 epochs of 3 steps. The GTU forward and
    cheb_sat run once per block of every forward pass, the GTU backward once
    per block of every train step. Then the whole-model check: one test
    batch in float32, the fused tail against the im2col tail on the run's
    best weights."""
    trainer, _, out = run_gambia(root, "gambia_dense_fuse_gtu", 2, fuse_gtu=True)
    check(trainer.fuse_gtu, "the Trainer resolved fuse_gtu off")
    check_launches(out, per_forward=("cheb_sat", "gtu_fwd"), per_step=("gtu_bwd",))
    out["model_check"] = tail_check(trainer, torch.float32, TOL)
    # the bf16 backward runs only in bf16: the same batch in the compute dtype
    out["model_check_bf16"] = tail_check(trainer, torch.bfloat16, FUSED_TOL[torch.bfloat16][0])
    print("main_path", json.dumps(out), flush=True)
    return out


def tail_check(trainer, dtype, tol):
    """One test batch through the fused and the im2col GTU tail in
    ``dtype`` on the run's weights, deterministic: the predictions must
    agree within ``tol`` of scale. Also the gradients of the GTU convs'
    weights and biases under the SmoothL1 loss (through the fused backward
    kernel on one side), reported as the worst relative |Δ|, checked
    finite."""
    from dstagnn_drought_tpu_torch.ops.nn import smooth_l1_loss

    x_full, y_full = trainer._splits["test"]
    bs = trainer.cfg.training.batch_size
    x, y, c = x_full[:bs], y_full[:bs], trainer.constants
    params = [p for n, p in trainer.model.named_parameters() if ".gtu" in f".{n}"]
    check(len(params) == 6 * trainer.cfg.training.nb_block, "GTU parameters not found")
    preds, grads = {}, {}
    for fused in (True, False):
        pred = trainer.model(x, adj_pa=c["adj_pa"], cheb_polys=c["cheb_polys"],
                             deterministic=True, compute_dtype=dtype, use_pallas=True,
                             fuse_gtu=fused)
        grads[fused] = torch.autograd.grad(smooth_l1_loss(pred, y), params)
        preds[fused] = pred.detach().float()
    torch.cuda.synchronize()
    err, rel = rel_err(preds[True], preds[False])
    grad_rel = max(rel_err(a, b)[1] for a, b in zip(grads[True], grads[False]))
    finite = all(bool(torch.isfinite(t).all()) for t in (preds[True], *grads[True]))
    name = str(dtype).split(".")[-1]
    check(rel <= tol and finite,
          f"fuse_gtu vs im2col tail at GAMBIA width, {name}: {rel:.3g} of scale > {tol}")
    return {"dtype": name, "batch": bs, "max_abs_err": err, "rel_err": rel, "tol": tol,
            "gtu_grad_rel_err": grad_rel}


def phase_gambia_bell_fuse_gtu(root: Path):
    """GAMBIA BELL tiles with fuse_gtu = true, one epoch: F and the GTU
    forward once per block of every forward pass, K1, K2 and the GTU
    backward once per block of every train step, cheb_sat never."""
    _, _, out = run_gambia(root, "gambia_bell_tiles_fuse_gtu", 1, fuse_gtu=True, **BELL_TILES)
    check_launches(out, per_forward=("bell_fused", "gtu_fwd"),
                   per_step=("bell_k1", "bell_k2", "gtu_bwd"), never=("cheb_sat",))
    print("main_path", json.dumps(out), flush=True)
    return out


def measure_gambia_fuse_gtu(root: Path, rounds: int = 2, paths=("dense", "bell_tiles")):
    """GAMBIA train-step time and peak device memory with the fused GTU
    tail against the im2col tail, on each of ``paths`` (dense with
    use_pallas, BELL tiles), each pair alternated in one process (im2col,
    fused, fused, im2col); then a profile of an epoch of each. Peak memory:
    max_memory_allocated over an epoch, after reset_peak_memory_stats, less
    what was allocated before it (the other trainers' weights and data)."""
    ds, A, pa = gambia_data()
    keys = {"dense": {}, "bell_tiles": BELL_TILES}
    configs = {}
    for path in paths:
        configs[f"{path}_im2col"] = keys[path]
        configs[f"{path}_fused"] = dict(fuse_gtu=True, **keys[path])
    trainers = {}
    for name, kw in configs.items():
        trainers[name] = Trainer(gambia_config(A.shape[0], **kw), dataset=ds, adj_merge=A,
                                 adj_pa=pa, experiments_root=str(root / f"mg_{name}"),
                                 device="cuda")
        trainers[name].train_epoch(0)  # warm-up
    times = {name: [] for name in configs}
    peak = {name: [] for name in configs}
    order = [f"{path}_{tail}" for path in paths
             for tail in ("im2col", "fused", "fused", "im2col") * rounds]
    for i, name in enumerate(order):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainers[name].train_epoch(i + 1)
        times[name].append((time.perf_counter() - t0) / trainers[name].last_epoch_steps * 1e3)
        peak[name].append((torch.cuda.max_memory_allocated() - base) / 2 ** 20)
    out = {"path": "gambia_fuse_gtu_step_ms", **times,
           "epoch_peak_mib": peak,
           "profile": {name: profile_epoch(trainers[name]) for name in configs}}
    print("measure", json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 10-13: the Trainer's knobs (remat, debug, rollback, evaluate)
# ---------------------------------------------------------------------------

REMAT_LOSS_RTOL = 1e-6  # remat recomputes the same bits; the losses may differ by atomics only


class deterministic_cudnn:
    """cuDNN restricted to deterministic algorithms inside the block, so
    two runs of one computation give the same bits (restored after)."""

    def __enter__(self):
        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.was


def pems08_subset(n_train: int, n_eval: int) -> ArrayDataset:
    """The first ``n_train`` training windows and ``n_eval`` validation and
    test windows of the in-repo PEMS08-width parity dataset."""
    with np.load(REPO / "benchmarks" / "parity_runs" / "parity_dataset.npz") as f:
        cut = lambda s, n: Split(np.ascontiguousarray(f[f"{s}_x"][:n], np.float32),
                                 np.ascontiguousarray(f[f"{s}_y"][:n], np.float32))
        return ArrayDataset(train=cut("train", n_train), val=cut("val", n_eval),
                            test=cut("test", n_eval), mean=f["mean"], std=f["std"])


def remat_pair(make, label: str, nb: int, forward_kernels, backward_kernels) -> dict:
    """One train epoch then one validation pass of the Trainer ``make(remat)``
    builds, without then with remat, each from the same seed and both
    through the graphed epoch (the recompute's dropout replayed inside the
    graph by ``RematReplay``): the epoch losses within REMAT_LOSS_RTOL, the
    forward kernels launched once per block of every train step and eval
    forward without remat and twice per train step with it (the recompute
    in the backward), the backward kernels once per block of every train
    step on both sides (``launches_run``); the weights and the dropout
    generator's state after the epoch equal bit for bit (a recompute that
    drew new masks would move only the gradients); then each side's
    ms/step and peak memory over a second epoch (``epoch_peak``: the graph
    pool's free bytes are the step's activations)."""
    side, after = {}, {}
    for remat in (False, True):
        trainer = make(remat)
        bs = trainer.cfg.training.batch_size
        val_batches = -(-len(trainer.dataset.val) // bs)
        reset_launches()
        loss = trainer.train_epoch(0)
        after[remat] = ({k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
                        trainer.generator.get_state())
        trainer.evaluate("val")
        torch.cuda.synchronize()
        launches = launches_run(read_launches(), [trainer])
        steps = trainer.last_epoch_steps
        ms, peak = epoch_peak(trainer, 1)  # warm: time and peak of the next epoch
        for k in forward_kernels:
            want = nb * ((2 if remat else 1) * steps + val_batches)
            check(launches[k] == want, f"{label} remat={remat}: {k} launches {launches[k]} "
                                       f"!= {want}")
        for k in backward_kernels:
            check(launches[k] == nb * steps,
                  f"{label} remat={remat}: {k} launches {launches[k]} != {nb * steps}")
        check(math.isfinite(loss), f"{label} remat={remat}: loss {loss}")
        side[remat] = {"train_loss": loss, "steps": steps, "val_batches": val_batches,
                       "epoch_peak_mib": peak, "ms_per_step_epoch2": ms,
                       "launches": {k: launches[k] for k in (*forward_kernels,
                                                             *backward_kernels)}}
        del trainer
        torch.cuda.empty_cache()
    rel = abs(side[True]["train_loss"] - side[False]["train_loss"]) / abs(side[False]["train_loss"])
    check(rel <= REMAT_LOSS_RTOL, f"{label}: remat loss vs eager {rel:.3g} > {REMAT_LOSS_RTOL}")
    (w_eager, g_eager), (w_remat, g_remat) = after[False], after[True]
    w_diff = max(float((w_remat[k].float() - w_eager[k].float()).abs().max()) for k in w_eager)
    weights_equal = all(torch.equal(w_remat[k], w_eager[k]) for k in w_eager)
    generator_equal = torch.equal(g_remat, g_eager)
    check(weights_equal, f"{label}: weights after the remat epoch differ from eager's "
                         f"(max |d| {w_diff:.3g})")
    check(generator_equal, f"{label}: the generator after the remat epoch differs from eager's")
    return {"path": label, "eager": side[False], "remat": side[True], "loss_rel_diff": rel,
            "loss_bit_equal": side[True]["train_loss"] == side[False]["train_loss"],
            "weights_bit_equal": weights_equal, "weights_max_abs_diff": w_diff,
            "generator_equal": generator_equal,
            "peak_ratio": side[True]["epoch_peak_mib"] / side[False]["epoch_peak_mib"]}


def phase_remat(root: Path, card: str):
    """remat on the card: GAMBIA dense at full width (bf16, use_pallas,
    fuse_gtu; cheb_sat and the GTU kernels) and PEMS08 width fused
    (fuse_tat, fuse_spatial, bf16, dropout 0.05; the TAt and spatial
    kernels), each eager and with remat from one seed (remat_pair)."""
    ds, A, pa = gambia_data()
    gambia = lambda remat: Trainer(
        gambia_config(A.shape[0], fuse_gtu=True, remat=remat), dataset=ds, adj_merge=A,
        adj_pa=pa, experiments_root=str(root / f"remat_gambia_{remat}"), device="cuda")
    out = [remat_pair(gambia, "gambia_dense_fuse_gtu_bf16", 2, ("cheb_sat", "gtu_fwd"),
                      ("gtu_bwd",))]
    conf = write_pems08_project(root, "SYNTH08R", **FUSED_KEYS)
    sub = pems08_subset(3 * PEMS08_TRAINING["batch_size"], PEMS08_TRAINING["batch_size"])

    def pems(remat):
        from dstagnn_drought_tpu_torch.config import load_config

        cfg = load_config(conf)
        cfg.training.remat = remat
        return Trainer(cfg, dataset=sub, experiments_root=str(root / f"remat_pems_{remat}"),
                       device="cuda")

    out.append(remat_pair(pems, "pems08_fused_bf16", PEMS08_TRAINING["nb_block"],
                          ("tat_fwd", "spatial_fwd"), ("tat_bwd", "spatial_bwd")))
    for line in out:
        line["card"] = card
        print("remat", json.dumps(line), flush=True)
    return out


def expect_error(fn, error, needle: str, what: str) -> str:
    """Run ``fn``; it must raise ``error`` with ``needle`` in its message.
    Returns the message."""
    try:
        fn()
    except error as exc:
        check(needle in str(exc), f"{what}: the error does not name {needle!r}: {exc}")
        return str(exc)
    check(False, f"{what}: no {error.__name__} raised")


def phase_debug(root: Path, card: str):
    """Debug mode on the card at PEMS08 width (float32, use_pallas): three
    clean checked steps whose losses equal the eager steps' bit for bit,
    cheb_sat launched once per block of each; then three faults, each of
    which must raise naming its source: an inf in a Chebyshev plane (read by
    the cheb_sat kernel alone: a model constant that no op before the kernel
    touches) names the cheb_sat kernel, a NaN in an input sample names the
    gather that emitted it, an index outside the split raises before the
    gather (the context is still usable after it)."""
    from dstagnn_drought_tpu_torch import debug
    from dstagnn_drought_tpu_torch.config import load_config
    from dstagnn_drought_tpu_torch.training.step import train_step

    conf = write_pems08_project(root, "SYNTH08D")
    bs, nb = PEMS08_TRAINING["batch_size"], PEMS08_TRAINING["nb_block"]
    sub = pems08_subset(3 * bs, bs)
    trainers = {}
    for checked in (False, True):
        cfg = load_config(conf)
        cfg.training.debug = checked
        trainers[checked] = Trainer(cfg, dataset=sub, device="cuda",
                                    experiments_root=str(root / f"debug_{checked}"))
    eager, tr = trainers[False], trainers[True]
    check(tr.checked_step is not None and eager.checked_step is None, "debug not resolved")
    x_full, y_full = tr._splits["train"]
    idx = np.arange(3 * bs).reshape(3, bs)
    w = torch.ones(bs, device=tr.device)
    losses = {False: [], True: []}
    times = {False: [], True: []}
    reset_launches()
    for b in range(3):
        for checked in (False, True):
            t = trainers[checked]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if checked:
                loss = t.checked_step(t.model, t.optimizer, x_full, y_full, idx[b],
                                      t.constants, weights=w, generator=t.generator, batch=b)
            else:
                i = torch.from_numpy(idx[b]).to(t.device)
                loss = train_step(t.model, t.optimizer, x_full[i], y_full[i], t.constants,
                                  weights=w, generator=t.generator, **t._step_kw)
            losses[checked].append(float(loss))
            times[checked].append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()["cheb_sat"]
    check(launches == 2 * 3 * nb, f"debug: cheb_sat launches {launches} != {2 * 3 * nb}")
    check(losses[True] == losses[False],
          f"debug: checked losses {losses[True]} != eager {losses[False]}")
    # an inf only the kernel reads: T_1 at one entry of the Chebyshev stack
    polys = tr.constants["cheb_polys"]
    keep = polys.clone()
    polys[1, 3, 5] = float("inf")
    step = lambda xs, ix, b: tr.checked_step(tr.model, tr.optimizer, xs, y_full, ix,
                                             tr.constants, weights=w, generator=tr.generator,
                                             batch=b)
    reset_launches()
    kernel_msg = expect_error(lambda: step(x_full, idx[0], 3), debug.NonFiniteError,
                              "the cheb_sat kernel", "cheb_sat poison")
    check(read_launches()["cheb_sat"] == 1, "the cheb_sat poison raised after another launch")
    polys.copy_(keep)
    poisoned = x_full.clone()
    poisoned[5, 7, 0, 2] = float("nan")
    input_msg = expect_error(lambda: step(poisoned, idx[0], 4), debug.NonFiniteError,
                             "aten.index", "input poison")
    check(input_msg.startswith("nan"), f"input poison: {input_msg}")
    oob = idx[0].copy()
    oob[-1] = len(sub.train)
    index_msg = expect_error(lambda: step(x_full, oob, 5), debug.BatchIndexError,
                             "before the gather", "out-of-range index")
    after = float(step(x_full, idx[1], 6))  # the CUDA context survived the refusal
    check(math.isfinite(after), f"debug: loss after the faults {after}")
    out = {"path": "pems08_debug_f32", "card": card, "losses": losses[True],
           "bit_equal": True, "cheb_sat_launches": launches,
           "checked_ms": times[True], "eager_ms": times[False],
           "checked_over_eager": sum(times[True][1:]) / sum(times[False][1:]),
           "kernel_poison": kernel_msg, "input_poison": input_msg,
           "index_fault": index_msg}
    print("debug", json.dumps(out), flush=True)
    return out


def phase_rollback(root: Path, card: str):
    """nan_policy = rollback at GAMBIA BELL tiles (bf16; F, K1, K2):
    Trainer.run for 2 epochs; the first run of epoch 1 starts from a model
    with a NaN weight (the test's injection, with the epoch's steps really
    run), so its loss is NaN; exactly one rollback to epoch 0's checkpoint,
    after which the model, the Adam state and the generator equal the
    checkpoint's and every param group's lr is halved; the retried epoch and
    the test loss are finite; F launched once per block of every forward,
    K1 and K2 once per block of every train step actually run (the graphs'
    replays counted through ``graph_stats``). The rollback replaces Adam's
    state, the generator's and the lr, so the retried epoch captures a new
    train graph, and its per-step losses equal those of an eager trainer
    that loads epoch 0's checkpoint and halves the lr (bit for bit, or
    within the spread of two such eager runs)."""
    from dstagnn_drought_tpu_torch.training import checkpoint as ckpt

    ds, A, pa = gambia_data()
    trainer = Trainer(gambia_config(A.shape[0], nan_policy="rollback", **BELL_TILES),
                      dataset=ds, adj_merge=A, adj_pa=pa,
                      experiments_root=str(root / "rollback"), device="cuda")
    lr0 = trainer.cfg.training.learning_rate
    train_epoch, rollback = trainer.train_epoch, trainer._rollback_to_last_good
    seen = {"epochs": [], "checks": None, "losses": []}

    def flaky_epoch(epoch):
        seen["epochs"].append(epoch)
        if epoch == 1 and seen["epochs"].count(1) == 1:
            with torch.no_grad():
                trainer.model.final_fc.weight[0, 0] = float("nan")
        loss = train_epoch(epoch)
        seen["losses"].append(list(trainer.last_losses))
        return loss

    def checked_rollback(epoch):
        rollback(epoch)
        state = ckpt.restore_checkpoint(ckpt.latest_checkpoint(trainer.run_dir),
                                        trainer.device)
        model = all(torch.equal(v, state["model"][k])
                    for k, v in trainer.model.state_dict().items())
        saved = state["optimizer"]["state"]
        now = trainer.optimizer.state_dict()["state"]
        adam = all(torch.equal(now[p][k].cpu(), saved[p][k].cpu())
                   for p in saved for k in saved[p])
        gen = torch.equal(trainer.generator.get_state(), state["generator"].cpu())
        lrs = [g["lr"] for g in trainer.optimizer.param_groups]
        latest = ckpt.latest_checkpoint(trainer.run_dir)
        seen["checks"] = {"model_equal": model, "adam_equal": adam, "generator_equal": gen,
                          "lr": lrs, "checkpoint": Path(latest).name, "checkpoint_path": latest}

    trainer.train_epoch, trainer._rollback_to_last_good = flaky_epoch, checked_rollback
    bs = trainer.cfg.training.batch_size
    batches = {s: -(-len(getattr(ds, s)) // bs) for s in ("train", "val", "test")}
    reset_launches()
    result = trainer.run(2)
    torch.cuda.synchronize()
    launches = launches_run(read_launches(), [trainer])
    c = seen["checks"]
    check(trainer._rollbacks == 1 and c is not None, f"rollbacks {trainer._rollbacks}")
    check(seen["epochs"] == [0, 1, 1], f"epochs run {seen['epochs']}")
    check(c["model_equal"] and c["adam_equal"] and c["generator_equal"],
          f"state after the rollback differs from the checkpoint: {c}")
    check(all(lr == lr0 / 2 for lr in c["lr"]), f"lr after the rollback {c['lr']}")
    check(math.isfinite(result["test_loss"]), f"rollback: test loss {result['test_loss']}")
    steps = 3 * batches["train"]  # epoch 0, the poisoned epoch 1, its retry
    forwards = steps + 2 * batches["val"] + batches["test"]
    nb = trainer.cfg.training.nb_block
    for k, want in (("bell_fused", forwards), ("bell_k1", steps), ("bell_k2", steps)):
        check(launches[k] == want * nb, f"rollback: {k} launches {launches[k]} != {want} x {nb}")
    events = [json.loads(line) for line in
              (Path(trainer.run_dir) / "metrics.jsonl").read_text().splitlines()]
    rb = [e for e in events if e["event"] == "rollback"]
    check(len(rb) == 1 and rb[0]["lr"] == lr0 / 2, f"rollback events {rb}")
    trains = [r for r in trainer.graph_stats if r["graph"] == "train"]
    check(len(trains) == 2, f"rollback: {len(trains)} train graphs, expected a new capture "
                            f"after the rollback ({graph_summary(trainer)})")
    def eager_resumed():  # Adam's load_state_dict keeps the tensors it is given: a state each
        ref = Trainer(gambia_config(A.shape[0], **BELL_TILES), dataset=ds, adj_merge=A,
                      adj_pa=pa, experiments_root=str(root / "rollback_eager"), device="cuda")
        ref._load(ckpt.restore_checkpoint(c["checkpoint_path"], trainer.device))
        for g in ref.optimizer.param_groups:
            g["lr"] = lr0 / 2
        ref.train_epoch_eager(1)
        return list(ref.last_losses)

    retried = seen["losses"][1]
    held = held_losses("rollback: the retried epoch", retried, eager_resumed)
    c.pop("checkpoint_path")
    out = {"path": "gambia_bell_tiles_rollback_bf16", "card": card, **c,
           "retried_losses": retried, "retried_vs_eager": held, "graphs": graph_summary(trainer),
           "train_losses": [e["train_loss"] for e in events if e["event"] == "epoch"],
           "test_loss": result["test_loss"], "launches": {k: launches[k] for k in
                                                         ("bell_fused", "bell_k1", "bell_k2")},
           "train_steps_run": steps, "forward_passes": forwards}
    print("rollback", json.dumps(out), flush=True)
    return out


def phase_evaluate(root: Path, card: str):
    """The evaluate CLI on phase 3's PEMS08 run: ``--use-pallas
    --export-attention --checkpoint <best>`` on the card; predictions equal
    to that run's test dump within TOL of scale, four finite (3, 170, 170)
    maps, the CSV equal to block 0 head 0, the maps equal to the CPU's from
    the same checkpoint within TOL of scale, cheb_sat once per block of
    every test batch's forward (the attention sample's forward takes JAX's
    export path, without ``use_pallas``, and launches none). Then the train
    CLI with ``--use-pallas --profile DIR --tensorboard`` for its profiled
    epoch: the trace must name a cheb_sat kernel; whether a TensorBoard
    writer was there is printed (without tensorboardX it is disabled, as in
    JAX)."""
    import importlib.util

    from dstagnn_drought_tpu_torch.cli import evaluate, train as train_cli
    from dstagnn_drought_tpu_torch.config import load_config

    conf, exp = root / "SYNTH08.conf", root / "exp"
    run_dir = next(exp.glob("SYNTH08/*"))
    dump = next(run_dir.glob("output_epoch_*_test.npz"))
    best = int(dump.name.split("_")[2])
    with np.load(dump) as d:
        want = d["prediction"]
    ckpt_path = run_dir / f"epoch_{best}.pt"
    bs, nb = PEMS08_TRAINING["batch_size"], PEMS08_TRAINING["nb_block"]
    reset_launches()
    t0 = time.perf_counter()
    with trainers_made() as made:
        evaluate.main(["--config", str(conf), "--experiments-root", str(exp), "--use-pallas",
                       "--export-attention", "--attention-sample", "24",
                       "--checkpoint", str(ckpt_path)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launches_run(read_launches(), made)["cheb_sat"]
    forwards = -(-len(want) // bs)
    check(launches == forwards * nb,
          f"evaluate: cheb_sat launches {launches} != {forwards} forwards x {nb}")
    with np.load(run_dir / f"output_epoch_{best}_test.npz") as d:
        got = d["prediction"]
    err, rel = rel_err(torch.from_numpy(got), torch.from_numpy(want))
    check(rel <= TOL, f"evaluate predictions vs the run's dump: {rel:.3g} > {TOL}")
    with np.load(run_dir / "attention_test.npz") as f:
        maps = [f[f"block_{i}"] for i in range(nb)]
        check(sorted(f.files) == [f"block_{i}" for i in range(nb)], f"maps {f.files}")
    check(all(m.shape == (3, 170, 170) and np.isfinite(m).all() for m in maps),
          f"maps {[m.shape for m in maps]}")
    csv = np.loadtxt(run_dir / "attention_test.csv", delimiter=",")
    check(np.allclose(csv, maps[0][0], rtol=1e-6, atol=0), "attention CSV != block 0 head 0")
    cpu = Trainer(load_config(conf), experiments_root=str(root / "eval_cpu"), device="cpu")
    cpu.model.load_state_dict(torch.load(ckpt_path, map_location="cpu",
                                         weights_only=True)["model"])
    cpu_maps = cpu.attention_maps("test", 24)
    map_rel = max(rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
                  for a, b in zip(maps, cpu_maps))
    check(map_rel <= TOL, f"attention maps card vs CPU: {map_rel:.3g} > {TOL}")
    del cpu
    prof_dir = root / "profile"
    reset_launches()
    train_cli.main(["--config", str(conf), "--epochs", "1", "--use-pallas", "--profile",
                    str(prof_dir), "--tensorboard",
                    "--experiments-root", str(root / "exp_profile")])
    trace = (prof_dir / "trace.json").read_text()
    names = [n for _, ns in SAT_PASSES for n in ns if n in trace]
    check(names, "the profile trace names no cheb_sat kernel")
    tb_dir = next((root / "exp_profile").glob("SYNTH08/*")) / "tb"
    tb = importlib.util.find_spec("tensorboardX") is not None
    events = list(tb_dir.glob("*tfevents*")) if tb_dir.is_dir() else []
    check(bool(events) == tb, f"tensorboard writer {tb} but event files {events}")
    out = {"path": "pems08_evaluate_cli", "card": card, "checkpoint": ckpt_path.name,
           "cheb_sat_launches": launches, "forwards": forwards, "max_abs_err": err,
           "rel_err": rel, "map_card_vs_cpu_rel": map_rel, "seconds": seconds,
           "trace_kernels": names, "trace_mib": len(trace) / 2 ** 20,
           "profile_cheb_sat_launches": read_launches()["cheb_sat"],
           "tensorboard": "written" if tb else "disabled (no tensorboardX)"}
    print("evaluate", json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 15: the whole-epoch runners as CUDA graphs
# ---------------------------------------------------------------------------

# the configurations whose graphed epochs replay every kernel (forward
# kernels, backward kernels), PERF.md section 6's table
GRAPHED = {
    "gambia_dense_fuse_gtu": (("cheb_sat", "gtu_fwd"), ("gtu_bwd",)),
    "gambia_bell_tiles_fuse_gtu": (("bell_fused", "gtu_fwd"), ("bell_k1", "bell_k2", "gtu_bwd")),
    "pems08_fused": (("tat_fwd", "spatial_fwd"), ("tat_bwd", "spatial_bwd")),
}
# the csrc file of each counter's kernels
COUNTER_SOURCE = {"cheb_sat": "cheb_sat.cu", "bell_fused": "bell_fused.cu",
                  "bell_k1": "bell_bwd.cu", "bell_k2": "bell_bwd.cu", "tat_fwd": "tat_fused.cu",
                  "tat_bwd": "tat_fused.cu", "spatial_fwd": "block_spatial_fused.cu",
                  "spatial_bwd": "block_spatial_fused.cu", "gtu_fwd": "gtu_fused.cu",
                  "gtu_bwd": "gtu_fused.cu"}


def graphed_makers(root: Path) -> dict:
    """{configuration: make(dtype, name) → a Trainer on the card}: GAMBIA
    dense with use_pallas and fuse_gtu, GAMBIA BELL tiles with fuse_gtu
    (dropout 0.05, 3 steps an epoch, 1 val batch), PEMS08 width with
    fuse_tat and fuse_spatial (3 steps of 64 windows, 1 val batch)."""
    from dstagnn_drought_tpu_torch.config import load_config

    ds, A, pa = gambia_data()
    conf = write_pems08_project(root, "SYNTH08G", **FUSED_KEYS)
    bs = PEMS08_TRAINING["batch_size"]
    sub = pems08_subset(3 * bs, bs)

    def gambia(**keys):
        return lambda dtype, name: Trainer(
            gambia_config(A.shape[0], compute_dtype=dtype, **keys), dataset=ds, adj_merge=A,
            adj_pa=pa, experiments_root=str(root / name), device="cuda")

    def pems(dtype, name):
        cfg = load_config(conf)
        cfg.training.compute_dtype = dtype
        return Trainer(cfg, dataset=sub, experiments_root=str(root / name), device="cuda")

    return {"gambia_dense_fuse_gtu": gambia(fuse_gtu=True),
            "gambia_bell_tiles_fuse_gtu": gambia(fuse_gtu=True, **BELL_TILES),
            "pems08_fused": pems}


def graphed_run(make, name: str, graphed: bool):
    """A new trainer's two epochs and validation pass, eager
    (``train_epoch_eager``, ``evaluate_eager``) or graphed: (trainer,
    record of the per-step losses, final weights, val predictions and
    loss, the launches that ran, ms/step of each epoch and the peak device
    memory from before the trainer was built)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = make(name)
    reset_launches()
    losses, ms = [], []
    for e in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (tr.train_epoch if graphed else tr.train_epoch_eager)(e)
        ms.append((time.perf_counter() - t0) / tr.last_epoch_steps * 1e3)
        losses += tr.last_losses
    pred, val_loss = (tr.evaluate if graphed else tr.evaluate_eager)("val")
    torch.cuda.synchronize()
    return tr, {"losses": losses, "pred": pred, "val_loss": val_loss,
                "weights": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
                "launches": launches_run(read_launches(), [tr]), "ms_per_step": ms,
                "run_peak_mib": (torch.cuda.max_memory_allocated() - base) / 2 ** 20}


def run_diff(a: dict, b: dict) -> dict:
    """The largest |Δ| between two runs' per-step losses, weights and val
    predictions (0 everywhere: the same bits)."""
    return {"losses": max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
            "weights": max(float((a["weights"][k].float() - b["weights"][k].float()).abs().max())
                           for k in a["weights"]),
            "pred": float(np.abs(a["pred"] - b["pred"]).max())}


def held_to_eager(label: str, got: dict, eager: dict, make, name: str) -> dict:
    """``got`` against the eager run ``eager``: the same bits, or, where a
    second eager run (``make``) already differs from the first (atomics in
    a plain op), within that spread. Returns the differences."""
    diff = run_diff(got, eager)
    out = {"diff": diff, "bit_equal": not any(diff.values())}
    if not out["bit_equal"]:
        tr, again = graphed_run(make, name, False)
        del tr
        spread = run_diff(again, eager)
        out["eager_spread"] = spread
        check(all(diff[k] <= spread[k] for k in diff),
              f"{label}: graphed vs eager {diff} outside the eager spread {spread}")
    return out


def graphed_pair(make, label: str, dtype: str, kernels, nb: int, measure: bool) -> dict:
    """One configuration in one dtype: two epochs and a val pass eager,
    then graphed, from the same weights and generator seed (``held_to_eager``);
    the launches the graphs ran (``launches_run``) equal the eager run's,
    each forward kernel once per block of every step and val batch, each
    backward kernel once per block of every step; the train graph captured
    once and replayed for every step but the warm-up, the val graph for
    every batch but its warm-up. With ``measure``: the two alternated over
    two rounds (eager, graphed, graphed, eager) for wall ms/step, then a
    profiled epoch of each: device ms/step, the busy share, and the csrc
    kernels' launches by name, equal in the two (a pair that differs is
    profiled once more and kept in ``trace_misreads``)."""
    fwd, bwd = kernels
    t0 = time.perf_counter()
    mk = lambda name: make(dtype, name)
    eager_tr, eager = graphed_run(mk, f"{label}_{dtype}_eager", False)
    graph_tr, graph = graphed_run(mk, f"{label}_{dtype}_graphed", True)
    steps = graph_tr.last_epoch_steps
    val_batches = -(-len(graph_tr.dataset.val) // graph_tr.cfg.training.batch_size)
    want = {k: nb * (2 * steps + val_batches) if k in fwd else nb * 2 * steps if k in bwd else 0
            for k in eager["launches"]}
    check(eager["launches"] == want, f"{label} {dtype}: eager launches {eager['launches']} "
                                     f"!= {want}")
    check(graph["launches"] == want, f"{label} {dtype}: graphed launches (graph_stats) "
                                     f"{graph['launches']} != {want}")
    records = {r["graph"]: r for r in graph_tr.graph_stats}
    check(len(graph_tr.graph_stats) == 2 and records["train"]["replays"] == 2 * steps - 1
          and records["eval"]["replays"] == val_batches - 1,
          f"{label} {dtype}: graph records {graph_summary(graph_tr)}")
    per_step = {k: nb if k in fwd + bwd else 0 for k in want}
    check(records["train"]["captured"] == per_step,
          f"{label} {dtype}: the train graph captured {records['train']['captured']}")
    out = {"path": label, "dtype": dtype, "steps_per_epoch": steps,
           "held": held_to_eager(f"{label} {dtype}", graph, eager, mk, f"{label}_{dtype}_eager2"),
           "launches": graph["launches"], "graphs": graph_summary(graph_tr),
           "eager_ms_per_step": eager["ms_per_step"], "graphed_ms_per_step": graph["ms_per_step"],
           "eager_run_peak_mib": eager["run_peak_mib"],
           "graphed_run_peak_mib": graph["run_peak_mib"],
           "graph_pool_free_mib": pool_free_mib(graph_tr)}
    if measure:
        times = {False: [], True: []}
        for graphed in (False, True, True, False):
            tr = graph_tr if graphed else eager_tr
            epoch = 2 + len(times[graphed])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (tr.train_epoch if graphed else tr.train_epoch_eager)(epoch)
            times[graphed].append((time.perf_counter() - t0) / tr.last_epoch_steps * 1e3)
        # the profiler can lose a few device records (seen once on the H100:
        # the three cheb_sat kernels of one replay, while the launch counters
        # were exact): a pair of traces that disagree is read once more, and
        # the second pair must agree
        misread = []
        for _ in range(2):
            prof = {g: profile_epoch(graph_tr if g else eager_tr, top=6, eager=not g,
                                     shapes=False) for g in (False, True)}
            names = prof[False]["csrc_kernels"]
            if prof[True]["csrc_kernels"] == names:
                break
            misread.append({"eager": names, "graphed": prof[True]["csrc_kernels"]})
        check(prof[True]["csrc_kernels"] == names,
              f"{label} {dtype}: the graphed epoch's trace {prof[True]['csrc_kernels']} != "
              f"the eager epoch's {names} (and in the read before: {misread[:1]})")
        seen = {csrc_kernels()[n] for n in names}
        for k in fwd + bwd:
            check(COUNTER_SOURCE[k] in seen, f"{label} {dtype}: no {COUNTER_SOURCE[k]} kernel "
                                             f"in the graphed epoch's trace")
        out.update(rounds={"eager": times[False], "graphed": times[True]},
                   profile={("graphed" if g else "eager"): {
                       k: prof[g][k] for k in ("device_ms_per_step", "busy_share", "wall_ms",
                                               "steps", "kernel_launches", "annotation_ms",
                                               "csrc_kernels", "top_kernels")} for g in prof},
                   trace_sources=sorted(seen), trace_misreads=misread)
    del eager_tr, graph_tr
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def resume_recaptures(make, label: str) -> dict:
    """A trainer that captured its graphs (``run(1)``: epoch 0 and its
    checkpoint, the val and test graphs) resumes from that checkpoint, which
    replaces Adam's state and the generator's: its next graphed epoch (a
    new capture) gives the per-step losses of an eager trainer that loads
    the same checkpoint, bit for bit (or within the eager spread)."""
    from dstagnn_drought_tpu_torch.training import checkpoint as ckpt

    tr = make(f"{label}_resume")
    tr.run(1)
    captured = len(tr.graph_stats)
    check(tr.resume() and tr.epoch == 1, f"{label}: resume found no checkpoint")
    tr.train_epoch(1)

    def eager_resumed():
        eager = make(f"{label}_resume_eager")
        eager._load(ckpt.restore_checkpoint(ckpt.latest_checkpoint(tr.run_dir), tr.device))
        eager.train_epoch_eager(1)
        return list(eager.last_losses)

    trains = [r for r in tr.graph_stats if r["graph"] == "train"]
    check(len(trains) == 2 and len(tr.graph_stats) > captured,
          f"{label}: no new capture after resume ({graph_summary(tr)})")
    return {"path": label, "losses": tr.last_losses, "train_captures": len(trains),
            **held_losses(f"{label} resumed", tr.last_losses, eager_resumed)}


def held_losses(label: str, got: list, eager) -> dict:
    """Per-step losses ``got`` against those of ``eager()`` (an eager
    run): the same bits, or within the spread of a second eager run."""
    want = eager()
    diff = max(abs(a - b) for a, b in zip(got, want))
    out = {"eager_losses": want, "max_abs_diff": diff, "bit_equal": diff == 0}
    if diff:
        again = eager()
        out["eager_spread"] = max(abs(a - b) for a, b in zip(again, want))
        check(diff <= out["eager_spread"], f"{label}: graphed losses {got} vs eager {want} "
                                           f"(|d| {diff:.3g}, {out})")
    return out


def phase_graphed(root: Path, card: str, measure_dtype: str = "bfloat16") -> dict:
    """The whole-epoch runners as CUDA graphs on the card, at the three
    configurations whose kernels cover every TPU kernel's port
    (``GRAPHED``), float32 and bf16 (``graphed_pair``; measured in
    ``measure_dtype``); then a resume that must capture again
    (``resume_recaptures``, GAMBIA dense bf16)."""
    makers = graphed_makers(root)
    out = {"card": card, "pairs": []}
    for label, make in makers.items():
        nb = PEMS08_TRAINING["nb_block"] if label.startswith("pems08") else 2
        for dtype in ("float32", "bfloat16"):
            line = graphed_pair(make, label, dtype, GRAPHED[label], nb, dtype == measure_dtype)
            line["card"] = card
            print("graphed", json.dumps(line), flush=True)
            out["pairs"].append(line)
    dense = lambda n: makers["gambia_dense_fuse_gtu"]("bfloat16", n)
    for key, fn in (("resume", resume_recaptures), ("capturable", capturable_moves)):
        t0 = time.perf_counter()
        out[key] = fn(dense, "gambia_dense_fuse_gtu_bf16")
        out[key]["seconds"] = time.perf_counter() - t0
        print(f"graphed_{key}", json.dumps(out[key]), flush=True)
    out["host_constant"] = host_constant_capture()
    print("graphed_host_constant", json.dumps(out["host_constant"]), flush=True)
    return out


def host_constant_capture() -> str:
    """What a CUDA-graph capture says of a constant made on the card from a
    Python scalar (a copy from pageable host memory), the pattern ``ops/``
    replaced by device fills for the graphed epochs."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            torch.tensor(2.0, device="cuda").sqrt()
    except RuntimeError as exc:
        return f"refused: {exc}"
    finally:
        del graph
    return "captured"


def capturable_moves(make, label: str) -> dict:
    """Two eager epochs with the card's capturable Adam (its step counts
    and bias corrections on the card) against the same with Adam as it was
    before the graphs (not capturable), from the same weights and seed:
    whether the per-step losses move, and by how much."""
    from dstagnn_drought_tpu_torch.training.step import make_optimizer

    losses = {}
    for capturable in (True, False):
        tr = make(f"{label}_capturable_{capturable}")
        if not capturable:
            tr.optimizer = make_optimizer(tr.model.parameters(), tr.cfg.training.learning_rate)
        losses[capturable] = []
        for e in range(2):
            tr.train_epoch_eager(e)
            losses[capturable] += tr.last_losses
        del tr
    diff = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
    return {"path": label, "capturable": losses[True], "not_capturable": losses[False],
            "max_abs_diff": diff, "bit_equal": diff == 0}


# ---------------------------------------------------------------------------
# phase 14: multi-device training, P ranks sharing the one card
# ---------------------------------------------------------------------------

MULTI_P = 4
# (label, compute dtype, data_axis, graph_axis, halo_overlap, dropout,
# fuse_gtu and fuse_tat, dense): the GAMBIA BELL-tiles configuration, or
# with dense the GAMBIA dense one (use_pallas: cheb_sat), with P ranks on
# the card; dropout stays on where every rank is data rank 0 (whose draws
# are the single-rank run's) and is off at data_axis = 2, whose data rank 1
# draws its own
MULTI_RUNS = (
    ("graph4_overlap_f32", "float32", 1, 4, True, 0.05, False, False),
    ("graph4_overlap_bf16", "bfloat16", 1, 4, True, 0.05, False, False),
    ("data2_graph2_f32", "float32", 2, 2, False, 0.0, False, False),
    ("graph4_overlap_bf16_fused", "bfloat16", 1, 4, True, 0.05, True, False),
    ("dense_graph4_f32", "float32", 1, 4, False, 0.05, False, True),
)
# a rank's epoch activation peak at most this share of the eager single-rank
# run's (the node axis sharded from the batch to the loss, the node-row
# regions keeping their inputs' rows): every BELL-tiles run at graph = 4,
# and the dense one at its own limit (block 2's whole conv, scores and
# cheb_sat's float32 backward live for a moment in its recompute)
MULTI_PEAK_SHARE = 0.4
MULTI_PEAK_GATED = ("graph4_overlap_f32", "graph4_overlap_bf16", "graph4_overlap_bf16_fused")
MULTI_DENSE_PEAK_SHARE = 0.5
# (per-step losses rtol; the first step's gradients as max |Δ| over max
# |single| of each tensor, and the final weights and val predictions as
# max |Δ| over max(1, max |single|)) against the single-rank run of the
# same weights
MULTI_TOL = {"float32": (2e-3, 5e-3), "bfloat16": (1e-2, 1e-2)}
MULTI_BF16_TOL = 1e-2  # a bf16 kernel against its plain version, of scale
# F/K1/K2 at GAMBIA block 2's widths on a rank's tile list: B, H, C, T, Co, d_k
MULTI_SHAPE = (4, 2, 32, GAMBIA_T_IN, 32, 32)


def multi_trainer(root: Path, label: str, dtype: str, data_axis: int, graph_axis: int,
                  overlap: bool, dropout: float, fused: bool, dense: bool) -> Trainer:
    ds, A, pa = gambia_data()
    cfg = gambia_config(A.shape[0], **({} if dense else BELL_TILES))
    t = cfg.training
    t.compute_dtype, t.dropout, t.halo_overlap = dtype, dropout, overlap
    t.data_axis, t.graph_axis = data_axis, graph_axis
    t.fuse_gtu = t.fuse_tat = fused
    return Trainer(cfg, dataset=ds, adj_merge=A, adj_pa=pa,
                   experiments_root=str(root / label), device="cuda")


def first_step_grads(tr):
    """Hook the trainer's first step. Returns (grads, own, undo): ``grads``
    fills with every parameter's gradient as Adam takes it (after the
    graph- and data-group sums), ``own``, where the step sums over a group,
    with this rank's gradient before the first sum (the control a missing
    sum would leave: at graph = 4 the node-row parameters' graph sum);
    ``undo`` removes the hooks. train_step looks ``comm.reduce_gradients``
    up at each call."""
    from dstagnn_drought_tpu_torch.parallel import comm

    names = {id(p): n for n, p in tr.model.named_parameters()}
    grads, own = {}, {}
    reduce, step = comm.reduce_gradients, tr.optimizer.step

    def now():
        return {names[id(p)]: p.grad.detach().clone() for p in tr.model.parameters()
                if p.grad is not None}

    def reduce_first(params, group):
        if group is not None and not own:
            own.update(now())
        return reduce(params, group)

    def step_first(*a, **k):
        if not grads:
            grads.update(now())
        return step(*a, **k)

    def undo():
        comm.reduce_gradients = reduce
        del tr.optimizer.step

    comm.reduce_gradients, tr.optimizer.step = reduce_first, step_first
    return grads, own, undo


def multi_run(root: Path, run: tuple, single: bool = False) -> tuple[dict, dict]:
    """One timed eager epoch of 3 steps (``train_epoch_eager``, also on one
    process when ``single``) and one eval of ``run``, the launch counts set
    to 0 just before and read just after each. Returns (record, whole
    tensors): the per-step losses, val predictions, a digest of every
    parameter this rank holds whole, the launches, the epoch's ms/step and
    its activation peak (``max_memory_allocated`` after
    ``reset_peak_memory_stats``, less what was allocated before the epoch:
    this process's, so a rank's own); the final weights, the first step's
    gradients (gathered whole from the slices) and, where the step sums
    over a group, the rank's own first-step gradients before the first sum,
    float32 numpy."""
    label, dtype = run[:2]
    tr = (multi_trainer(root, f"{label}_single", dtype, 1, 1, *run[4:]) if single
          else multi_trainer(root, *run))
    grads, own, undo = first_step_grads(tr)
    reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train_epoch_eager(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / tr.last_epoch_steps * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    train_launches, losses = launches_run(read_launches(), [tr]), list(tr.last_losses)
    undo()
    if tr.layout is not None:  # collective over the data row
        grads = tr.layout.whole_state(grads)
        own = tr.layout.whole_state(own) if own else own
    before = graph_snapshot([tr])
    reset_launches()
    pred, val_loss = tr.evaluate("val")
    torch.cuda.synchronize()
    eval_launches = launches_run(read_launches(), [tr], before)
    numpy = lambda d: {k: v.float().cpu().numpy() for k, v in d.items()}
    state = {"weights": numpy(tr.model_state()), "grads": numpy(grads), "own": numpy(own)}
    digests = {n: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
               for n, p in tr.model.named_parameters()
               if tr.layout is None or not tr.layout.sliced(n)}
    record = {"losses": losses, "val_loss": val_loss, "pred": pred, "digests": digests,
              "train_launches": train_launches, "eval_launches": eval_launches,
              "ms_per_step": ms, "steps": tr.last_epoch_steps, "peak_mib": peak_mib,
              "node_rows": None if tr.rows is None else tr.rows.nloc,
              "backend": None if tr.mesh is None else tr.mesh.backend}
    return record, state


def shard_view(tiles, pattern):
    """A RankTiles in the attributes bell_inputs reads of a BlockEllGraph."""
    BS = pattern.shape[-1]
    rows = tiles.num_tiles * BS
    return types.SimpleNamespace(
        tensors={**tiles.tensors, "active_pattern": pattern}, num_active=tiles.num_active,
        block_size=BS, padded_nodes=rows, n_nodes=rows, num_tiles=tiles.num_tiles)


def shard_kernels(tiles, pattern, dtype, seed: int):
    """F, K1 and K2 against their plain versions on one rank's tile list at
    GAMBIA block 2's widths (MULTI_SHAPE): (rows, the kernels' outputs)."""
    B, H, C, T, Co, dk = MULTI_SHAPE
    BS = pattern.shape[-1]
    ins = bell_inputs(shard_view(tiles, pattern), B, H, C, T, Co, dk, dtype, seed)
    t = tiles.tensors
    calls = {
        "bell_fused": ((t["tile_start"], t["tile_count"], t["active_src"], ins["q"], ins["k"],
                        ins["bias"], ins["cheb"], ins["x"], ins["thetas"]),
                       bell_fused.bell_forward_cuda, bell_fused.bell_forward_plain),
        "bell_k1": ((t["active_src"], t["active_tgt"], t["tile_start"], t["tile_count"],
                     ins["thetas"], ins["gm"], ins["x"], ins["w"]), bell_bwd.bell_k1_cuda,
                    lambda a_s, a_t, _ts, _tc, *r: bell_bwd.bell_k1_plain(a_s, a_t, *r)),
        "bell_k2": ((t["src_start"], t["src_count"], t["src_order"], t["active_tgt"],
                     ins["thetas"], ins["gm"], ins["w"]), bell_bwd.bell_k2_cuda,
                    bell_bwd.bell_k2_plain),
    }
    bounds = bell_bounds(B, H, tiles.num_active, BS, dk, C, T, Co, tiles.num_tiles * BS,
                         dtype)
    rows, outs = [], {}
    for name, (args, kern, plain) in calls.items():
        got, want = kern(*args), plain(*args)
        got, want = (got if isinstance(got, tuple) else (got,)), (
            want if isinstance(want, tuple) else (want,))
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        tol = (MULTI_BF16_TOL if dtype == torch.bfloat16
               else TOL if name == "bell_fused" else GRAD_TOL)
        check(all(e[1] <= tol for e in errs),
              f"{name} at the shard shape ({dtype}): errors {errs} over {tol} of scale")
        rows.append({"kernel": name, "dtype": str(dtype).replace("torch.", ""),
                     "A": tiles.num_active, "R": tiles.num_tiles,
                     "max_abs_err": max(e[0] for e in errs), "err_of_scale": max(e[1] for e in errs),
                     "ms": cuda_ms(lambda: kern(*args), 10),
                     "plain_ms": cuda_ms(lambda: plain(*args), 3),
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1]})
        outs[name] = got
    return rows, outs


def sublist_tiles(plan, ov, r: int, side: str):
    """(tile list of rank r's overlap sublist ``side``, the same without its
    pad tiles' entries, its entries' patterns, its true tile count)."""
    from dstagnn_drought_tpu_torch.parallel.bell_partition import RankTiles

    a = side == "A"
    pick = lambda name: getattr(ov, name + side)[r]
    ts, tc, a_src, a_tgt, sel = (pick(n) for n in ("tile_start", "tile_count", "a_src",
                                                     "a_tgt", "sel"))
    n_src = plan.tiles_per_shard if a else plan.ns_max
    n_true = ov.n_localA[r] if a else plan.tiles_per_shard - ov.n_localA[r]
    n = int(ts[-1] + tc[-1])
    m = int(ts[n_true]) if n_true < len(ts) else n
    ts2, tc2 = ts.copy(), tc.copy()
    ts2[n_true:], tc2[n_true:] = m, 0
    zero = np.zeros((1,) + plan.pattern_act.shape[2:], bool)
    pattern = torch.from_numpy(np.concatenate([plan.pattern_act[r], zero])[sel[:n]]).cuda()
    return (RankTiles(ts, tc, a_src[:n], a_tgt[:n], n_src, "cuda"),
            RankTiles(ts2, tc2, a_src[:m], a_tgt[:m], n_src, "cuda"), pattern, n_true)


def check_pad_entries(plan, ov) -> dict:
    """Pad entries on the card: a sublist's pad tiles (one entry of zero
    pattern and zero Chebyshev value) give F output rows of exactly 0, and
    K1's dΘ and K2's dx equal, bit for bit, those of the same list without
    them; the plan's inert tiles (a self slot with an all-masked row,
    −1e30 everywhere) give finite, zero output rows."""
    from dstagnn_drought_tpu_torch.parallel.bell_partition import RankTiles

    out = {}
    cases = [(r, s) for r in range(plan.num_shards) for s in ("A", "B")
             if (ov.n_localA[r] if s == "A" else plan.tiles_per_shard - ov.n_localA[r])
             < getattr(ov, "tiles" + s).shape[1]]
    check(bool(cases), "no overlap sublist has a pad tile to check")
    r, side = cases[0]
    BS = plan.block_size
    full, bare, pattern, n_true = sublist_tiles(plan, ov, r, side)
    for dtype in (torch.float32, torch.bfloat16):
        _, got = shard_kernels(full, pattern, dtype, seed=11)
        ins = bell_inputs(shard_view(full, pattern), *MULTI_SHAPE, dtype, 11)
        m, t = bare.num_active, bare.tensors
        w = ins["w"][:, :m].contiguous()
        dA, dth = bell_bwd.bell_k1_cuda(t["active_src"], t["active_tgt"], t["tile_start"],
                                        t["tile_count"], ins["thetas"], ins["gm"], ins["x"], w)
        dx = bell_bwd.bell_k2_cuda(t["src_start"], t["src_count"], t["src_order"],
                                   t["active_tgt"], ins["thetas"], ins["gm"], w)
        f = got["bell_fused"][0]
        pad_rows = f[:, n_true * BS:full.n_targets * BS]
        check(bool((pad_rows == 0).all()), f"pad tiles' F rows are not 0 ({dtype})")
        check(torch.equal(got["bell_k1"][1], dth), f"pad entries change K1's dΘ ({dtype})")
        check(torch.equal(got["bell_k2"][0], dx), f"pad entries change K2's dx ({dtype})")
        out[str(dtype).replace("torch.", "")] = {
            "rank": r, "sublist": side, "pad_tiles": full.n_targets - n_true,
            "pad_rows_max_abs": float(pad_rows.float().abs().max())}
    # rank P-1's whole list holds the inert tiles past N
    r = plan.num_shards - 1
    n = plan.a_true[r]
    tiles = RankTiles(plan.tile_start[r], plan.tile_count[r], plan.a_src[r][:n],
                      plan.a_tgt[r][:n], plan.ns_max, "cuda")
    inert = [j for j in range(plan.tiles_per_shard)
             if (r * plan.tiles_per_shard + j) * BS >= plan.n_nodes]
    pattern = torch.from_numpy(plan.pattern_act[r][:n]).cuda()
    _, got = shard_kernels(tiles, pattern, torch.float32, seed=12)
    f = got["bell_fused"][0].reshape(MULTI_SHAPE[0], -1, BS, got["bell_fused"][0].shape[-1])
    check(bool(torch.isfinite(f).all()), "inert tiles give a non-finite F output")
    check(bool((f[:, inert] == 0).all()), "inert tiles' F rows are not 0")
    out["inert_tiles"] = {"rank": r, "tiles": inert}
    return out


def multi_plans() -> dict:
    """{G: the Trainer's BellTileShardPlan of the GAMBIA graph at graph = G}."""
    from dstagnn_drought_tpu_torch.ops.graph import cheb_polynomials, scaled_laplacian
    from dstagnn_drought_tpu_torch.parallel import bell_partition as bp

    _, A, pa = gambia_data()
    bell = block_ell_from_adjacency(A, block_size=BELL_TILES["block_size"])
    polys = cheb_polynomials(scaled_laplacian(torch.from_numpy(A)), 2).numpy()
    return {G: bp.build_bell_tile_shard_plan(bell, G, pa, polys) for G in (2, MULTI_P)}


def multi_rank(rank: int, root: str, kernels: bool = True) -> dict:
    """One rank of phase_multi: every run of MULTI_RUNS on its mesh; with
    ``kernels`` rank 0 then checks and times F, K1 and K2 at its shard
    shapes, the GTU forward and backward on its node rows (B·Np/P rows of
    the fused tail) and the pad entries, alone on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    for run in MULTI_RUNS:
        record, state = multi_run(Path(root), run)
        out[run[0]] = dict(record, state=state if rank == 0 else None)
    if rank == 0 and kernels:
        from dstagnn_drought_tpu_torch.parallel import bell_partition as bp

        plan = multi_plans()[MULTI_P]
        n = plan.a_true[0]
        tiles = bp.RankTiles(plan.tile_start[0], plan.tile_count[0], plan.a_src[0][:n],
                             plan.a_tgt[0][:n], plan.ns_max, "cuda")
        pattern = torch.from_numpy(plan.pattern_act[0][:n]).cuda()
        out["kernels"] = [row for dtype in (torch.float32, torch.bfloat16)
                          for row in shard_kernels(tiles, pattern, dtype, seed=10)[0]]
        B, _, C = MULTI_SHAPE[:3]
        out["gtu_kernels"] = [row for dtype in (torch.float32, torch.bfloat16)
                              for row in gtu_rows(f"rank0_graph{MULTI_P}", B,
                                                  plan.padded_nodes // MULTI_P, C, GAMBIA_T_IN,
                                                  dtype, seed=20)]
        out["pad"] = check_pad_entries(plan, bp.build_overlap_lists(plan))
    return out


def grad_err(got: dict, want: dict, plan) -> tuple[float, str]:
    """(the largest max |Δ| over max |single| of one parameter's first-step
    gradient, that parameter): each tensor at its own scale, with no floor,
    so a gradient far below 1 is held as tightly as a large one."""
    worst = (0.0, "")
    for k, v in want.items():
        if plan is not None and k.endswith("cheb_conv_SAt.mask_tiles"):
            v = plan.pack_active(v)
        err, scale = float(np.abs(got[k] - v).max()), float(np.abs(v).max())
        rel = err / scale if scale else (0.0 if err == 0 else math.inf)
        worst = max(worst, (rel, k))
    return worst


def data_split_floor(root: Path, run: tuple) -> tuple[tuple[float, str], dict]:
    """The single-rank model's first-step gradient as the sum of its data
    ranks' row shares (each over the whole batch's weight sum, as a data
    mesh computes it, with no collective) against the whole batch's, at
    each tensor's own scale (grad_err): what reordering the batch sum alone
    moves, the floor under a data mesh's gradient error. Returns (that
    error, the summed shares' gradients)."""
    from dstagnn_drought_tpu_torch.training.step import train_step

    label, dtype, D = run[:3]
    tr = multi_trainer(root, f"{label}_split", dtype, 1, 1, *run[4:])
    t = tr.cfg.training
    x_full, y_full = tr._splits["train"]
    idx, n_valid = tr.dataset.batch_indices("train", t.batch_size, shuffle=True,
                                            seed=t.seed * 100003)
    ib = torch.from_numpy(idx[0].astype(np.int64)).cuda()
    w = torch.from_numpy((np.arange(idx.shape[1]) < n_valid).astype(np.float32)).cuda()
    keep = types.SimpleNamespace(zero_grad=lambda set_to_none=True: None, step=lambda: None)

    def grads(parts):  # the parts' gradients summed in .grad
        tr.model.zero_grad(set_to_none=True)
        for rows in parts:
            train_step(tr.model, keep, x_full[ib[rows]], y_full[ib[rows]], tr.constants,
                       weights=w[rows], weight_total=w.sum(), generator=tr.generator,
                       **tr._step_kw)
        return {n: p.grad.float().cpu().numpy() for n, p in tr.model.named_parameters()
                if p.grad is not None}

    rows = t.batch_size // D
    whole = grads([slice(None)])
    split = grads([slice(d * rows, (d + 1) * rows) for d in range(D)])
    return grad_err(split, whole, None), split


def measure_graph_split_floor(parts: int = MULTI_P) -> dict:
    """The graph-split floor: the float32 single-rank run of
    ``graph4_overlap_f32`` with only the TAt's three projections (x @ [wq
    wk wv], a contraction over N) summed as the ``parts`` rank chunks of the
    padded node axis in rank order, as a row-parallel TAt would sum its
    partial products, against the unchanged run from the same weights and
    generator: the first-step gradients at each tensor's own scale
    (grad_err), and the unchanged run against itself. A measurement, not a
    gate: what splitting the TAt's contraction over 'graph' alone moves,
    beside phase 14's 5e-3 gradient gate. Builds the BELL kernels it runs;
    callable alone (``python -c "import chip_smoke as c;
    c.measure_graph_split_floor()"``)."""
    from dstagnn_drought_tpu_torch.models import dstagnn
    from dstagnn_drought_tpu_torch.ops.attention import _sqrt
    from dstagnn_drought_tpu_torch.ops.cuda import build
    from dstagnn_drought_tpu_torch.ops.nn import layer_norm

    build.build(("bell_fused", "bell_bwd"))
    run = next(r for r in MULTI_RUNS if r[0] == "graph4_overlap_f32")
    nloc = multi_plans()[parts].padded_nodes // parts
    plain = dstagnn.temporal_attention

    def split_tat(x, res_att, *, wq, wk, wv, wo, ln_scale, ln_bias, n_heads, d_k, d_v):
        """ops.attention.temporal_attention with its projection summed by
        rank chunks of N."""
        B, F, T, N = x.shape
        w = torch.cat([wq, wk, wv], dim=1)
        chunks = [slice(lo, min(lo + nloc, N)) for lo in range(0, N, nloc)]
        qkv = x[..., chunks[0]] @ w[chunks[0]]
        for c in chunks[1:]:  # rank order
            qkv = qkv + x[..., c] @ w[c]
        hk = n_heads * d_k
        q = qkv[..., :hk].reshape(B, F, T, n_heads, d_k)
        k = qkv[..., hk:2 * hk].reshape(B, F, T, n_heads, d_k)
        v = qkv[..., 2 * hk:].reshape(B, F, T, n_heads, d_v)
        scores = torch.einsum("bfqhd,bfkhd->bfhqk", q, k) / _sqrt(d_k, x) + res_att
        attn = torch.softmax(scores, dim=3)
        context = torch.einsum("bfhqk,bfkhd->bfqhd", attn, v).reshape(B, F, T, n_heads * d_v)
        return layer_norm(context @ wo + x, ln_scale, ln_bias), scores

    def first_grads(root, label, tat):
        dstagnn.temporal_attention = tat
        try:
            tr = multi_trainer(root, label, "float32", 1, 1, *run[4:])
            grads, _, undo = first_step_grads(tr)
            tr.train_epoch_eager(0)
            undo()
            return {k: v.float().cpu().numpy() for k, v in grads.items()}
        finally:
            dstagnn.temporal_attention = plain

    with tempfile.TemporaryDirectory(prefix="split_floor_") as tmp, deterministic_cudnn():
        root = Path(tmp)
        base = first_grads(root, "base", plain)
        again = first_grads(root, "again", plain)
        split = first_grads(root, "split", split_tat)
    out = {"measure": "graph_split_floor", "card": card_line(), "run": run[0],
           "parts": parts, "node_rows_a_part": nloc,
           "split_vs_single": grad_err(split, base, None),
           "single_vs_itself": grad_err(again, base, None)}
    print("measure", json.dumps(out), flush=True)
    return out


def multi_compare(label: str, dtype: str, got: dict, state: dict, ref: dict,
                  ref_state: dict, plan, split: dict | None = None) -> dict:
    """One run against the single-rank run of the same weights: per-step
    losses, the first step's whole gradients (which the collectives'
    backwards make: a 3-step run at lr 1e-4 moves no weight past the
    weights' limit), final weights and val predictions; on a data mesh the
    control, the rank's own gradient before the data-group sum, must fail
    the gradient gate, and the gradients are also held against the single
    model's data-row shares summed (``split``, data_split_floor)."""
    rtol, wtol = MULTI_TOL[dtype]
    losses, want = np.asarray(got["losses"]), np.asarray(ref["losses"])
    loss_err = float(np.max(np.abs(losses - want) / np.abs(want)))
    check(loss_err <= rtol, f"{label}: losses {losses} vs single {want} (rtol {rtol})")
    g_err, g_worst = grad_err(state["grads"], ref_state["grads"], plan)
    check(g_err <= wtol, f"{label}: first-step gradient of {g_worst} {g_err} of its scale "
          f"(limit {wtol})")
    vs_split = None
    if split is not None:
        vs_split = grad_err(state["grads"], split, plan)
        check(vs_split[0] <= wtol, f"{label}: first-step gradients vs the summed data-row "
              f"shares {vs_split} (limit {wtol})")
    control = None
    if state["own"]:
        control, c_worst = grad_err(state["own"], ref_state["grads"], plan)
        check(control > wtol, f"{label}: the control (no graph- or data-group sum) passes the "
              f"gradient gate: {control} of scale ({c_worst}) <= {wtol}")
    weight_err = 0.0
    for k, v in ref_state["weights"].items():
        if k.endswith("cheb_conv_SAt.mask_tiles"):
            v = plan.pack_active(v)
        weight_err = max(weight_err, float(np.abs(state["weights"][k] - v).max())
                         / max(1.0, float(np.abs(v).max())))
    check(weight_err <= wtol, f"{label}: weights {weight_err} of scale (limit {wtol})")
    pred_err = rel_err(torch.from_numpy(got["pred"]), torch.from_numpy(ref["pred"]))[1]
    check(pred_err <= wtol, f"{label}: val predictions {pred_err} of scale (limit {wtol})")
    return {"loss_rel_err": loss_err, "grad_err_of_scale": g_err, "grad_worst": g_worst,
            "grad_err_vs_split_sum": vs_split, "control_no_sum_err_of_scale": control,
            "weight_err_of_scale": weight_err, "pred_err_of_scale": pred_err}


def multi_launches(label: str, overlap: bool, fused: bool, dense: bool,
                   records: list) -> dict:
    """Each rank's launches in 3 train steps and one eval batch of 2 blocks.
    BELL tiles: F once per block of every forward pass and K1/K2 once per
    block of every train step, twice each with the overlapped sublists;
    cheb_sat never. Dense: cheb_sat once per block of every forward pass
    and again in every train step's backward, where the spatial middle's
    node-row region runs again; no BELL kernel. With ``fused`` the GTU
    kernels once per block of every forward and of every train step's
    backward, the TAt's forward once more in every train step's backward
    (the recompute of EmbedT to the pre-conv's region), else never. Returns
    rank 0's launches of the run by kernel."""
    per = 0 if dense else (2 if overlap else 1)
    on = 1 if fused else 0
    for rank, rec in enumerate(records):
        tr, ev = rec["train_launches"], rec["eval_launches"]
        want = {"bell_fused": (3 * 2 * per, 1 * 2 * per), "bell_k1": (3 * 2 * per, 0),
                "bell_k2": (3 * 2 * per, 0), "cheb_sat": (3 * 2 * 2 * dense, 1 * 2 * dense),
                "gtu_fwd": (3 * 2 * on, 1 * 2 * on), "gtu_bwd": (3 * 2 * on, 0),
                "tat_fwd": (3 * 2 * 2 * on, 1 * 2 * on), "tat_bwd": (3 * 2 * on, 0)}
        for k, (t_want, e_want) in want.items():
            check(tr[k] == t_want and ev[k] == e_want,
                  f"{label} rank {rank}: {k} launches {tr[k]} (train), {ev[k]} (eval); "
                  f"expected {t_want}, {e_want}")
    return {k: records[0]["train_launches"][k] + records[0]["eval_launches"][k]
            for k in ("bell_fused", "bell_k1", "bell_k2", "cheb_sat", "gtu_fwd", "gtu_bwd",
                      "tat_fwd", "tat_bwd")}


def multi_cli_nccl(root: Path) -> dict:
    """The training CLI with --distributed at world size 1 (RANK=0
    WORLD_SIZE=1, NCCL: the rank has the card to itself), one PEMS08 epoch,
    its test predictions equal bit for bit to the run without it."""
    import os
    import socket

    import torch.distributed as dist

    conf = write_pems08_project(root, name="SYNTH08_DIST")
    with deterministic_cudnn():
        _, _, _, _, plain_dir = run_pems08_cli(root, conf, root / "exp_single", epochs=1)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        os.environ.update(env)
        try:
            _, _, _, _, dist_dir = run_pems08_cli(root, conf, root / "exp_dist",
                                                  ["--distributed"], epochs=1)
            backend = dist.get_backend()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k in env:
                os.environ.pop(k)
    check(backend == "nccl", f"--distributed at world size 1 chose {backend}")
    preds = []
    for d in (plain_dir, dist_dir):
        with np.load(next(d.glob("output_epoch_*_test.npz"))) as f:
            preds.append(f["prediction"])
    check(np.array_equal(preds[0], preds[1]),
          "--distributed at world size 1 changed the test predictions")
    return {"backend": backend, "predictions_bit_equal": True}


def multi_records(root: Path, kernels: bool = True) -> tuple[dict, dict, list]:
    """Every run of MULTI_RUNS on one process (the eager single-rank
    references) and on P ranks sharing the card, and the data meshes'
    split floors: (singles {label: multi_run's (record, state)}, floors
    {label: data_split_floor}, every rank's multi_rank record)."""
    from dstagnn_drought_tpu_torch.parallel.launch import spawn

    singles = {}
    with deterministic_cudnn():
        for run in MULTI_RUNS:
            singles[run[0]] = multi_run(root, run, single=True)
        floors = {run[0]: data_split_floor(root, run) for run in MULTI_RUNS if run[2] > 1}
    gc.collect()  # the single-rank trainers' graph pools, before the ranks share the card
    torch.cuda.empty_cache()
    ranks = spawn(multi_rank, MULTI_P, str(root), kernels, timeout=600, init_dir=str(root))
    return singles, floors, ranks


def measure_multi() -> dict:
    """Phase 14's runs without its gates or rank 0's kernel checks: each
    run's rank activation peaks against the single run's, rank 0's and the
    single run's ms/step, the float32 first-step gradient error at each
    tensor's own scale. It goes through interfaces the package has had
    since node rows came in, so it also measures an older checkout (copy
    this file into it and run it from there, ``python -c "import chip_smoke
    as c; c.measure_multi()"``); runs parent and change in turns in one
    call to compare them. Builds the kernels the runs launch."""
    from dstagnn_drought_tpu_torch.ops.cuda import build

    build.build(("cheb_sat", "bell_fused", "bell_bwd", "tat_fused", "gtu_fused"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="measure_multi_") as tmp:
        singles, _, ranks = multi_records(Path(tmp), kernels=False)
    out = {"card": card_line(), "label": f"{MULTI_P} ranks sharing one H100", "runs": {}}
    plans = multi_plans()
    for run in MULTI_RUNS:
        label = run[0]
        records, (ref, ref_state) = [r[label] for r in ranks], singles[label]
        peaks = [r["peak_mib"] for r in records]
        out["runs"][label] = {
            "peak_mib_ranks": peaks, "peak_mib_single": ref["peak_mib"],
            "peak_share_of_single": max(peaks) / ref["peak_mib"],
            "ms_per_step_rank0": records[0]["ms_per_step"],
            "ms_per_step_single": ref["ms_per_step"], "node_rows": records[0]["node_rows"],
            "grad_err_of_scale": grad_err(records[0]["state"]["grads"], ref_state["grads"],
                                          plans[run[3]])}
    print("measure", json.dumps(out), flush=True)
    return out


def gather_rank(rank: int, shapes: dict, iters: int = 5) -> dict:
    """One rank of measure_gloo_gather: {label: ms of one all-gather (the
    port's ``comm.all_gather`` over the world, gloo) of a CUDA tensor of
    that (shape, dtype), the rank's rows, the calls fenced by
    ``torch.cuda.synchronize`` after two warm-up calls}."""
    import torch.distributed as dist

    from dstagnn_drought_tpu_torch.parallel import comm

    out = {}
    for label, (shape, dtype) in shapes.items():
        t = torch.randn(shape, device="cuda").to(getattr(torch, dtype))
        for _ in range(2):
            comm.all_gather(t, 1, dist.group.WORLD)
        torch.cuda.synchronize()
        comm.all_reduce(torch.zeros(1, device="cuda"), dist.group.WORLD)  # start together
        t0 = time.perf_counter()
        for _ in range(iters):
            comm.all_gather(t, 1, dist.group.WORLD)
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) / iters * 1e3
    return out


def measure_gloo_gather() -> dict:
    """The all-gather a node-row region makes of x's rows, timed alone: P
    ranks sharing the card over gloo, each gathering its rows of GAMBIA
    block 2's x (B, N/P, C, T) along the node axis (BELL tiles' 640 rows
    in float32 and bf16, the dense path's 535 in float32) and block 1's
    (F = 4). Rank 0's ms a gather; callable alone."""
    from dstagnn_drought_tpu_torch.parallel.launch import spawn

    B, C, T = 4, 32, GAMBIA_T_IN
    shapes = {"block2_x_rows640_f32": ((B, 640, C, T), "float32"),
              "block2_x_rows640_bf16": ((B, 640, C, T), "bfloat16"),
              "block2_x_rows535_f32": ((B, 535, C, T), "float32"),
              "block1_x_rows640_f32": ((B, 640, GAMBIA_F, T), "float32")}
    with tempfile.TemporaryDirectory(prefix="gloo_gather_") as tmp:
        ranks = spawn(gather_rank, MULTI_P, shapes, timeout=300, init_dir=tmp)
    out = {"card": card_line(), "label": f"{MULTI_P} ranks sharing one H100, gloo",
           "whole_mb": {k: math.prod(s) * MULTI_P * (4 if d == "float32" else 2) / 1e6
                        for k, (s, d) in shapes.items()},
           "ms_rank0": ranks[0], "ms_ranks_max": {k: max(r[k] for r in ranks) for k in shapes}}
    print("measure", json.dumps(out), flush=True)
    return out


def phase_multi(root: Path, card: str) -> dict:
    """Multi-device training (the parallel package) with P = 4 ranks sharing
    the one H100 over gloo (the backend rule: NCCL refuses two ranks on one
    card): GAMBIA BELL tiles, its node axis sharded over 'graph' from the
    batch to the loss, at graph = 4 with the overlapped halo in float32 and
    in bf16 (and in bf16 with fuse_gtu and fuse_tat), and at (data, graph) =
    (2, 2) without it, and GAMBIA dense (use_pallas, its spatial middle in a
    node-row region through cheb_sat) at graph = 4 in float32, each held
    against the eager single-rank run of the same
    weights in this call (per-step losses, the first step's whole
    gradients, final weights and val predictions; a control, each rank's
    gradient before the graph- or data-group sum, must fail the gradient
    gate), with the parameters every rank holds whole bit-identical across
    ranks and each rank's launches counted; each rank's epoch activation
    peak against the single run's (at most MULTI_PEAK_SHARE of it in
    MULTI_PEAK_GATED, MULTI_DENSE_PEAK_SHARE in the dense run); rank 0's F,
    K1 and K2 against their plain versions at
    its shard shapes, and the GTU at its node rows, the pad entries exactly
    0; each plan's exchange volume; then the CLI with --distributed at
    world size 1 under NCCL. ms/step are of P ranks sharing one card: no
    multi-GPU figure."""
    from dstagnn_drought_tpu_torch.parallel import bell_partition as bp
    from dstagnn_drought_tpu_torch.parallel import comm

    t0 = time.perf_counter()
    singles, floors, ranks = multi_records(root)
    plans = multi_plans()
    out = {"card": card, "ranks": MULTI_P, "label": f"{MULTI_P} ranks sharing one H100",
           "gloo_cuda_collectives": list(comm.GLOO_CUDA), "runs": {}}
    print("multi", json.dumps({"backend": "gloo (ranks share one card)",
                               "gloo_on_cuda_tensors": out["gloo_cuda_collectives"],
                               "staged_through_host": []}), flush=True)
    kernel_launches = {}
    n = gambia_data()[1].shape[0]
    for label, dtype, D, G, overlap, dropout, fused, dense in MULTI_RUNS:
        records = [r[label] for r in ranks]
        for name, digest in records[0]["digests"].items():
            check(all(r["digests"][name] == digest for r in records),
                  f"{label}: {name} differs across ranks")
        ref, ref_state = singles[label]
        floor, split = floors.get(label, (None, None))
        cmp = multi_compare(label, dtype, records[0], records[0]["state"], ref, ref_state,
                            plans[G], split)
        launches = multi_launches(label, overlap, fused, dense, records)
        if label == "graph4_overlap_bf16":
            kernel_launches.update({k: launches[k] for k in ("bell_fused", "bell_k1", "bell_k2")})
        if fused:
            kernel_launches.update({k: launches[k] for k in ("gtu_fwd", "gtu_bwd")})
        if dense:
            kernel_launches["cheb_sat"] = launches["cheb_sat"]
        peaks = [r["peak_mib"] for r in records]
        share = max(peaks) / ref["peak_mib"]
        limit = (MULTI_DENSE_PEAK_SHARE if dense
                 else MULTI_PEAK_SHARE if label in MULTI_PEAK_GATED else None)
        check(limit is None or share <= limit,
              f"{label}: a rank's activation peak {max(peaks):.1f} MiB is {share:.3f} of the "
              f"single-rank run's {ref['peak_mib']:.1f} (limit {limit})")
        nloc = -(-n // G) if dense else plans[G].padded_nodes // G
        check(all(r["node_rows"] == nloc for r in records),
              f"{label}: ranks hold {[r['node_rows'] for r in records]} node rows, not {nloc}")
        out["runs"][label] = {
            "dtype": dtype, "data_axis": D, "graph_axis": G, "halo_overlap": overlap,
            "dropout": dropout, "fuse_gtu_tat": fused, "dense": dense,
            "backend": records[0]["backend"], "peak_limit": limit, **cmp,
            "data_split_floor": floor,
            "losses": records[0]["losses"], "single_losses": ref["losses"],
            "launches_rank0": launches, "replicated_bit_identical": True,
            "ms_per_step_rank0": records[0]["ms_per_step"],
            "ms_per_step_single": ref["ms_per_step"],
            "peak_mib_ranks": peaks, "peak_mib_single": ref["peak_mib"],
            "peak_share_of_single": share, "node_rows": records[0]["node_rows"],
            "ms_label": f"{MULTI_P} ranks sharing one H100 ({card})"}
        print("multi", json.dumps({"run": label, **out["runs"][label]}), flush=True)
    for G, plan in plans.items():
        ov = bp.build_overlap_lists(plan)
        out[f"exchange_graph{G}"] = {**plan.halo_stats(), "ns_true": list(plan.ns_true),
                                     "exposed_blocks": list(ov.exposed_blocks),
                                     "local_tiles_A": list(ov.n_localA)}
        print("multi", json.dumps({"exchange": G, **out[f"exchange_graph{G}"]}), flush=True)
    out["kernels"] = ranks[0]["kernels"]
    out["gtu_kernels"] = ranks[0]["gtu_kernels"]
    out["kernel_launches"] = kernel_launches
    out["pad"] = ranks[0]["pad"]
    for row in out["kernels"] + out["gtu_kernels"]:
        print("multi", json.dumps({"shard_kernel": row}), flush=True)
    print("multi", json.dumps({"pad": out["pad"]}), flush=True)
    out["cli_distributed"] = multi_cli_nccl(root)
    out["seconds"] = time.perf_counter() - t0
    print("multi", json.dumps({"cli_distributed": out["cli_distributed"],
                               "seconds": out["seconds"]}), flush=True)
    return out


KERNEL_SITES = {
    "cheb_sat": ("dstagnn_drought_tpu_torch/csrc/cheb_sat.cu",
                 "dstagnn_drought_tpu/ops/pallas/cheb_sat.py:83"),
    "bell_fused": ("dstagnn_drought_tpu_torch/csrc/bell_fused.cu",
                   "dstagnn_drought_tpu/ops/pallas/bell_fused.py:553"),
    "bell_k1": ("dstagnn_drought_tpu_torch/csrc/bell_bwd.cu",
                "dstagnn_drought_tpu/ops/pallas/bell_bwd.py:363"),
    "bell_k2": ("dstagnn_drought_tpu_torch/csrc/bell_bwd.cu",
                "dstagnn_drought_tpu/ops/pallas/bell_bwd.py:597"),
    "tat_fwd": ("dstagnn_drought_tpu_torch/csrc/tat_fused.cu",
                "dstagnn_drought_tpu/ops/pallas/tat_fused.py:251"),
    "tat_bwd": ("dstagnn_drought_tpu_torch/csrc/tat_fused.cu",
                "dstagnn_drought_tpu/ops/pallas/tat_fused.py:283"),
    "spatial_fwd": ("dstagnn_drought_tpu_torch/csrc/block_spatial_fused.cu",
                    "dstagnn_drought_tpu/ops/pallas/block_spatial_fused.py:227"),
    "spatial_bwd": ("dstagnn_drought_tpu_torch/csrc/block_spatial_fused.cu",
                    "dstagnn_drought_tpu/ops/pallas/block_spatial_fused.py:255"),
    "gtu_fwd": ("dstagnn_drought_tpu_torch/csrc/gtu_fused.cu",
                "dstagnn_drought_tpu/ops/pallas/gtu_fused.py:177"),
    "gtu_bwd": ("dstagnn_drought_tpu_torch/csrc/gtu_fused.cu",
                "dstagnn_drought_tpu/ops/pallas/gtu_fused.py:204"),
}
# the TPU package's c-major variants of F, K1 and K2: the port's one c-major
# kernel of each replaces both layouts, so each gets a line of its own
C_MAJOR_SITES = {"bell_fused": "dstagnn_drought_tpu/ops/pallas/bell_fused.py:812",
                 "bell_k1": "dstagnn_drought_tpu/ops/pallas/bell_bwd.py:452",
                 "bell_k2": "dstagnn_drought_tpu/ops/pallas/bell_bwd.py:677"}


def kernel_lines(rows, bell_rows, fused_rows, gtu_rows, pems, gambia, tiles, fused, gtu,
                 gtu_bell, multi, pems07, large_n, long_t, wide, graphed, wide_fused):
    """One record per TPU kernel for the JSON line (13; a c-major variant's
    record repeats its port kernel's, ``kernel_of``): launches from its main
    path, times and bound at the main path's shape (the fused TAt and
    spatial rows: launches from the PEMS07 bf16 run, times at PEMS08
    blocks 2-4 as before, the PEMS07 shape's beside them, and the wide
    CLI runs' launches with their times at TAT_WIDE_SHAPES and
    SPATIAL_WIDE_SHAPES, ``wide_shapes``; the TAt and GTU
    rows also carry the large-N and long-T CLI runs' launches and their
    times at the shapes past the old caps, ``new_shapes``; the BELL rows
    the full-width CLI runs' launches and their times at BELL_NEW_SHAPES)."""
    main_row = next(r for r in rows if r["shape"] == "pems08_blocks2-4")
    g2 = next(r for r in rows if r["shape"] == "gambia_block2")
    src, site = KERNEL_SITES["cheb_sat"]
    out = [{
        "name": "cheb_sat", "route": "cuda", "source": src, "replaces": site,
        "launches": pems["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": "B=64 K=3 N=170 M=384 (PEMS08 blocks 2-4), x float32",
        "design": main_row["design"], "f32_bound_ms": main_row["f32_bound_ms"],
        "launches_gambia": gambia["launches"],
        "launches_dense_graph4_rank0": multi["kernel_launches"]["cheb_sat"],
        "gambia_block2": {k: g2[k] for k in ("x_dtype", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "f32_bound_ms")},
    }]
    for name in ("bell_fused", "bell_k1", "bell_k2"):
        mine = [r for r in bell_rows if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == "gambia_block2" and r["dtype"] == "bfloat16")
        src, site = KERNEL_SITES[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": site,
            "launches": tiles["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": "GAMBIA block 2, bf16: B=4 H=2 N=2139 BS=128 A=49 C=32 T=144 Co=32",
            "design": main["design"], "f32_ms": main["f32_ms"],
            "f32_design": bell_design(name, torch.float32),
            "launches_wide": {dt: run["launches"][name] for dt, run in wide.items()},
            "new_shapes": new_shape_times(mine, BELL_NEW_SHAPES),
        })
    out += [dict(line, name=f"{line['name']}_c", replaces=C_MAJOR_SITES[line["name"]],
                 kernel_of=line["name"]) for line in out if line["name"] in C_MAJOR_SITES]
    # F, K1 and K2 on rank 0's own tile list at graph = 4 (phase_multi)
    for name in ("bell_fused", "bell_k1", "bell_k2"):
        mine = [r for r in multi["kernels"] if r["kernel"] == name]
        main = next(r for r in mine if r["dtype"] == "bfloat16")
        src, site = KERNEL_SITES[name]
        out.append({
            "name": f"{name}@rank0_graph4", "kernel_of": name, "route": "cuda", "source": src,
            "replaces": site, "launches": multi["kernel_launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "f32_ms": next(r for r in mine if r["dtype"] == "float32")["ms"],
            "shape": f"GAMBIA block 2 on rank 0 of graph = 4, bf16: B=4 H=2 BS=128 "
                     f"A={main['A']} R={main['R']} C=32 T=144 Co=32",
        })
    # the GTU on rank 0's node rows at graph = 4 (phase_multi's fused run)
    for name in ("gtu_fwd", "gtu_bwd"):
        mine = [r for r in multi["gtu_kernels"] if r["kernel"] == name]
        main = next(r for r in mine if r["dtype"] == "bfloat16")
        src, site = KERNEL_SITES[name]
        out.append({
            "name": f"{name}@rank0_graph4", "kernel_of": name, "route": "cuda", "source": src,
            "replaces": site, "launches": multi["kernel_launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": main["library"], "design": main["design"],
            "f32_ms": next(r for r in mine if r["dtype"] == "float32")["ms"],
            "shape": f"rank 0's node rows at graph = 4, bf16: B=4 N={main['N']} C=32 T=144",
        })
    for name in ("tat_fwd", "tat_bwd", "spatial_fwd", "spatial_bwd"):
        mine = [r for r in fused_rows if r["kernel"] == name]
        main, f32 = (next(r for r in mine if r["shape"] == "pems08_blocks2-4"
                          and r["dtype"] == dt) for dt in ("bfloat16", "float32"))
        p07 = {r["dtype"]: r for r in mine if r["shape"] in ("pems07_n883", "pems07_blocks2-4")}
        src, site = KERNEL_SITES[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": site,
            "launches": pems07["bfloat16"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": "PEMS08 blocks 2-4, bf16: B=64 F=32 T=12 N=170 (TAt H=3 d_k=32; "
                     "spatial d=512 K=3 C=Co=32)",
            "launches_pems07_f32": pems07["float32"]["launches"][name],
            "launches_pems08": fused["launches"][name],
            "pems07": {dt: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                       for dt, r in p07.items()},
            "launches_wide": {run: out_["launches"][name] for run, out_ in wide_fused.items()},
            "wide_shapes": new_shape_times(mine, [s[0] for s in (
                TAT_WIDE_SHAPES if name.startswith("tat") else SPATIAL_WIDE_SHAPES)]),
        })
        if name.startswith("tat"):
            out[-1].update(
                launches_large_n={dt: run["launches"][name] for dt, run in large_n.items()},
                launches_long_t={dt: run["launches"][name] for dt, run in long_t.items()},
                new_shapes=new_shape_times(mine, TAT_NEW_SHAPES))
        else:
            out[-1]["launches_long_t"] = {dt: run["launches"][name] for dt, run in long_t.items()}
        out[-1].update(design=main["design"], f32_ms=f32["ms"], f32_design=f32["design"])
    for name in ("gtu_fwd", "gtu_bwd"):
        mine = [r for r in gtu_rows if r["kernel"] == name]
        main, f32 = (next(r for r in mine if r["shape"] == "gambia_block" and r["dtype"] == dt)
                     for dt in ("bfloat16", "float32"))
        src, site = KERNEL_SITES[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": site,
            "launches": gtu["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": main["library"], "design": main["design"],
            "shape": "GAMBIA block, bf16: B=4 N=2139 C=32 T=144",
            "launches_bell_tiles": gtu_bell["launches"][name],
            "launches_long_t": {dt: run["launches"][name] for dt, run in long_t.items()},
            "f32_ms": f32["ms"], "f32_design": f32["design"],
            "new_shapes": new_shape_times(mine, GTU_NEW_SHAPES),
        })
    # the launches replayed inside phase 15's CUDA graphs, by configuration
    for line in out:
        k = line.get("kernel_of", line["name"])
        line["launches_graphed"] = {f"{p['path']}_{p['dtype']}": p["launches"][k]
                                    for p in graphed["pairs"] if p["launches"][k]}
    return out


def new_shape_times(rows, shapes) -> dict:
    """{shape: {dtype: ms, plain_ms, bound_ms (and library_ms)}} of a
    kernel's rows at ``shapes``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    return {label: {r["dtype"]: {k: r[k] for k in keys if k in r}
                    for r in rows if r["shape"] == label} for label in shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", action="store_true",
                    help="also time epochs with the kernel and the plain path")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every phase's numbers to this file")
    ap.add_argument("--compare", type=Path, default=None, metavar="OUT",
                    help="build, then run only compare_run (one side of a comparison of "
                         "two commits) into OUT")
    ap.add_argument("--rows", type=Path, default=None, metavar="OUT",
                    help="build, then time only PERF.md rows 2-13 (measure_rows) into OUT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()

    report = build.build(("bell_fused", "bell_bwd", "tat_fused", "block_spatial_fused",
                          "gtu_fused") if args.rows else build.SOURCES)
    builds = {}
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f} s", flush=True)
        lines = [line.strip() for line in r["log"].splitlines()
                 if any(w in line for w in ("entry function", "registers", "spill", "error"))]
        for line in lines:
            print(f"  ptxas: {line}")
        builds[name] = {"seconds": r["seconds"], "ptxas": lines}
    print(f"card: {card}", flush=True)
    if args.compare is not None:
        compare_run(args.compare)
        return 0
    if args.rows is not None:
        measure_rows(args.rows)
        return 0

    phase_s = {}

    def timed(fn, *a):
        """fn(*a), its seconds printed and kept under its name; then the
        phase's trainers collected (a cycle can hold one, and with it its
        CUDA graphs' memory pool) and the cached blocks released."""
        t0 = time.perf_counter()
        r = fn(*a)
        phase_s[fn.__name__] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{fn.__name__}: {phase_s[fn.__name__]:.1f} s (reserved after: "
              f"{torch.cuda.memory_reserved() / 2 ** 20:.0f} MiB)", flush=True)
        return r

    rows = timed(phase_kernels)
    bell_rows = timed(phase_bell_kernels)
    fused_rows = timed(phase_fused_kernels)
    passes = ({"spatial": measure_spatial_passes(), "tat": measure_tat_passes()}
              if args.measure else None)
    gtu_rows = timed(phase_gtu_kernels)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        pems = timed(phase_pems08, root)
        fused = timed(phase_pems08_fused, root)
        pems07 = timed(phase_pems07_fused, root)
        large_n = timed(phase_large_n, root, args.measure)
        long_t = timed(phase_long_t, root, args.measure)
        wide_fused = timed(phase_wide_fused, root)
        measured = measure_pems08_epochs(root) if args.measure else None
        gambia = timed(phase_gambia, root)
        gtu = timed(phase_gambia_fuse_gtu, root)
        tiles = timed(phase_gambia_bell_tiles, root)
        gtu_bell = timed(phase_gambia_bell_fuse_gtu, root)
        rcm = timed(phase_gambia_bell_rcm, root)
        wide = timed(phase_gambia_wide, root)
        stag = timed(phase_stag, root)
        ell = timed(phase_gambia_ell, root)
        zoo = timed(phase_zoo, root, args.measure)
        with deterministic_cudnn():
            knobs = {"remat": timed(phase_remat, root, card),
                     "debug": timed(phase_debug, root, card)}
        knobs.update(rollback=timed(phase_rollback, root, card),
                     evaluate=timed(phase_evaluate, root, card))
        with deterministic_cudnn():  # so that two eager runs give the same bits
            graphed = timed(phase_graphed, root, card)
        multi = timed(phase_multi, root, card)
        if args.measure:
            measured = {"pems08": measured, "passes": passes,
                        "pems08_fused": measure_fused_steps(
                            root, root / "SYNTH08F.conf", "pems08_bf16_fused_step_ms"),
                        "pems07_fused": measure_pems07_fused(root),
                        "gambia": measure_gambia_steps(root),
                        "gambia_bell": measure_gambia_bell(root),
                        "gambia_fuse_gtu": measure_gambia_fuse_gtu(root),
                        "accuracy": measure_accuracy(root),
                        "graph_pipeline": measure_graph_pipeline(root),
                        "stag_full": measure_stag_full()}

    kernels = kernel_lines(rows, bell_rows, fused_rows, gtu_rows, pems, gambia, tiles, fused,
                           gtu, gtu_bell, multi, pems07, large_n, long_t, wide, graphed,
                           wide_fused)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card, "builds": builds, "cheb_sat": rows, "bell": bell_rows,
            "fused": fused_rows, "gtu": gtu_rows, "pems08": pems, "pems08_fused": fused,
            "pems07_fused": pems07, "large_n": large_n, "long_t": long_t,
            "wide_fused": wide_fused,
            "measure": measured, "gambia": gambia, "gambia_bell_tiles": tiles,
            "gambia_bell_rcm": rcm, "gambia_wide": wide, "gambia_fuse_gtu": gtu,
            "gambia_bell_tiles_fuse_gtu": gtu_bell, "stag": stag, "gambia_ell": ell,
            "zoo": zoo, "knobs": knobs, "graphed": graphed, "multi": multi, "kernels": kernels,
            "phase_seconds": phase_s, "seconds": time.perf_counter() - t_start,
        }, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
