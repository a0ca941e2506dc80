#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dstagnn_drought_tpu_torch) on one GPU.

Usage (from the repository root, on a machine with one CUDA card and nvcc):

    python3 chip_smoke.py [--measure] [--json PATH]

Phases; any failure exits non-zero:
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print the build time, the ptxas report and the card's name and
     power limit;
  2. hold each kernel against its plain PyTorch version on the card (TF32
     off) at the main path's shapes and at ragged shapes, forward and
     gradients, with CUDA-event times of both;
  3. the main path at full PEMS08 width: the training CLI, two epochs on
     benchmarks/parity_runs/parity_dataset.npz through the kernel, with the
     kernel's launch count read around the run;
  4. GAMBIA dense (N=2139, F=4, T=144, bfloat16): training steps through
     the Trainer, the kernel at N > 1024 and the multichannel/long-T tail;
  5. a JSON line with every kernel's numbers, then the device line.

``--measure`` adds timings of whole training epochs (PEMS08 width and
GAMBIA dense) with the kernel and with the plain aggregation, alternated in
one process, a torch.profiler breakdown of each, and a 25-epoch PEMS08
accuracy run of both paths checked against the reference model's recorded
test MAE.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig
from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
from dstagnn_drought_tpu_torch.ops.cuda import build, cheb_sat
from dstagnn_drought_tpu_torch.training.loop import Trainer

REPO = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): float32 on the CUDA cores
# and HBM3 bandwidth; at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL = 2e-4       # forward, kernel vs plain (precedent tests/test_pallas_cheb.py)
GRAD_TOL = 5e-3  # gradients (precedent tests/test_pallas_cheb.py)


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    # (label, B, K, N, M): the main path's shapes, then the ragged shapes of
    # tests/test_pallas_cheb.py::test_unaligned_shapes
    ("pems08_block1", 64, 3, 170, 12),
    ("pems08_blocks2-4", 64, 3, 170, 384),
    ("gambia_block1", 4, 2, 2139, 576),
    ("gambia_block2", 4, 2, 2139, 4608),
    ("ragged_n7", 1, 2, 7, 12),
    ("ragged_n130", 1, 2, 130, 15),
    ("ragged_n33", 1, 2, 33, 18),
]
GRAD_SHAPES = ("pems08_blocks2-4", "gambia_block1", "ragged_n7", "ragged_n130", "ragged_n33")


def cheb_sat_bound(B, K, N, M):
    flops = 2 * B * K * N * N * M
    nbytes = 4 * (B * K * N * N + 2 * K * N * N + B * N * M + B * K * N * M)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cheb_sat_inputs(B, K, N, M, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    scores = torch.randn(B, K, N, N, generator=g, device=dev)
    adj_pa = (torch.rand(N, N, generator=g, device=dev) < 0.3).float()
    masks = torch.randn(K, N, N, generator=g, device=dev)
    cheb = torch.randn(K, N, N, generator=g, device=dev)
    x = torch.randn(B, N, M, generator=g, device=dev)
    return scores, (adj_pa[None] * masks).contiguous(), cheb, x


def phase_kernels():
    rows = []
    for seed, (label, B, K, N, M) in enumerate(CHEB_SAT_SHAPES):
        s, bias, cheb, x = cheb_sat_inputs(B, K, N, M, seed)
        got = cheb_sat.sat_aggregate_cuda(s, bias, cheb, x)
        want = cheb_sat.sat_aggregate_plain(s, bias, cheb, x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, atol=TOL, rtol=TOL))
        row = {"shape": label, "B": B, "K": K, "N": N, "M": M,
               "max_abs_err": err, "ok": ok}
        if label in GRAD_SHAPES:
            row["grad_max_abs_err"] = grad_error(s, bias, cheb, x)
        iters = 5 if N > 1024 else 20
        row["ms"] = cuda_ms(lambda: cheb_sat.sat_aggregate_cuda(s, bias, cheb, x), iters)
        row["plain_ms"] = cuda_ms(lambda: cheb_sat.sat_aggregate_plain(s, bias, cheb, x), iters)
        row["bound_ms"], row["bound_by"] = cheb_sat_bound(B, K, N, M)
        print("cheb_sat", json.dumps(row), flush=True)
        check(ok, f"cheb_sat kernel vs plain at {label}: max |d| {err:.3g} > {TOL}")
        if "grad_max_abs_err" in row:
            check(row["grad_max_abs_err"] <= GRAD_TOL,
                  f"cheb_sat gradients at {label}: {row['grad_max_abs_err']:.3g}")
        rows.append(row)
        del s, bias, cheb, x, got, want
    return rows


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
# phase 3: PEMS08 full width through the CLI
# ---------------------------------------------------------------------------

PEMS08_TRAINING = dict(nb_block=4, n_heads=3, K=3, d_k=32, d_model=512,
                       nb_chev_filter=32, nb_time_filter=32, batch_size=64,
                       learning_rate=0.0001, seed=2024)


def write_pems08_project(root: Path) -> Path:
    """The in-repo parity dataset as a reference-format project: windowed
    npz plus headerless CSVs, with graph = AG so the loaders return ``adj``
    as adj_merge (binarized STAG) and ``stag`` as adj_pa (binarized STRG)."""
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
    training = "\n".join(f"{k} = {v}" for k, v in PEMS08_TRAINING.items())
    conf = root / "SYNTH08.conf"
    conf.write_text(f"""[Data]
adj_filename = {root}/adj.csv
graph_signal_matrix_filename = {root}/SYNTH08.npz
stag_filename = {root}/stag.csv
strg_filename = {root}/strg.csv
num_of_vertices = {n}
points_per_hour = 12
num_for_predict = 12
len_input = 12
dataset_name = SYNTH08

[Training]
model_name = dstagnn
in_channels = 1
graph = AG
num_of_hours = 1
num_of_days = 0
num_of_weeks = 0
epochs = 2
use_pallas = true
compute_dtype = float32
{training}
""")
    return conf


def phase_pems08(root: Path):
    from dstagnn_drought_tpu_torch.cli import train as train_cli

    conf = write_pems08_project(root)
    exp = root / "exp"
    with np.load(root / "SYNTH08_r1_d0_w0_dstagnn.npz") as f:
        sizes = {s: len(f[f"{s}_x"]) for s in ("train", "val", "test")}
    bs, nb, epochs = PEMS08_TRAINING["batch_size"], PEMS08_TRAINING["nb_block"], 2
    batches = {s: -(-n // bs) for s, n in sizes.items()}
    forwards = epochs * (batches["train"] + batches["val"]) + batches["test"]

    cheb_sat.launches = 0
    result = train_cli.main(["--config", str(conf), "--epochs", str(epochs),
                             "--use-pallas", "--experiments-root", str(exp)])
    torch.cuda.synchronize()
    launches = cheb_sat.launches

    run_dir = next(exp.glob("SYNTH08/*"))
    events = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    ep = [e for e in events if e["event"] == "epoch"]
    losses = [e["train_loss"] for e in ep]
    check(len(ep) == epochs, f"expected {epochs} epoch records, got {len(ep)}")
    check(all(math.isfinite(v) for v in losses + [e["val_loss"] for e in ep]),
          f"non-finite losses {losses}")
    check(losses[1] < losses[0], f"epoch-2 loss {losses[1]} not below epoch-1 {losses[0]}")
    check(any(run_dir.glob("epoch_*.pt")), "no checkpoint written")
    dumps = list(run_dir.glob("output_epoch_*_test.npz"))
    check(len(dumps) == 1, "no test prediction dump")
    with np.load(dumps[0]) as d:
        pred = d["prediction"]
    check(pred.shape == (sizes["test"], 170, 12) and bool(np.isfinite(pred).all()),
          f"bad test predictions {pred.shape}")
    overall = result["report"]["overall"]
    check(all(math.isfinite(overall[k]) for k in ("mae", "rmse", "mape")), "bad report")
    check(launches == forwards * nb,
          f"cheb_sat launches {launches} != {forwards} forward passes x {nb} blocks")
    ms_step = ep[1]["train_seconds"] / ep[1]["steps"] * 1e3
    out = {"path": "pems08_cli", "device": torch.cuda.get_device_name(0),
           "epochs": epochs, "train_losses": losses,
           "val_losses": [e["val_loss"] for e in ep], "test_overall": overall,
           "launches": launches, "forward_passes": forwards,
           "ms_per_step_epoch2": ms_step, "steps_per_epoch": ep[1]["steps"]}
    print("main_path", json.dumps(out), flush=True)
    return out


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


def profile_epoch(trainer, top: int = 12):
    """torch.profiler over one training epoch: device time by kernel name,
    the device-busy share of the wall time, and the launch count."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(1000)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3
    events = prof.key_averages()
    # device-side kernel records, and the host ops that launched them
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU and dev(e) > 0]
    busy_ms = sum(dev(e) for e in kernels)
    rank = lambda rows: [{"name": e.key[:90], "count": e.count, "device_ms": dev(e)}
                         for e in sorted(rows, key=dev, reverse=True)[:top]]
    return {"steps": trainer.last_epoch_steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_ops": rank(ops), "top_kernels": rank(kernels)}


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
    A = np.zeros((N, N), np.float32)
    idx = np.arange(N).reshape(nx, ny)
    A[idx[:-1].ravel(), idx[1:].ravel()] = 1
    A[idx[:, :-1].ravel(), idx[:, 1:].ravel()] = 1
    A = np.maximum(A, A.T)
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


def gambia_config(N: int, use_pallas: bool = True) -> Config:
    return Config(
        data=DataConfig(num_of_vertices=N, len_input=GAMBIA_T_IN,
                        num_for_predict=GAMBIA_T_PRED, dataset_name="GAMBIA_SYN",
                        points_per_hour=12),
        training=TrainingConfig(
            in_channels=GAMBIA_F, nb_block=2, n_heads=2, K=2, d_k=32, d_model=64,
            nb_chev_filter=32, nb_time_filter=32, batch_size=4, learning_rate=1e-4,
            num_of_hours=12, compute_dtype="bfloat16", use_pallas=use_pallas,
        ),
    ).validate()


def phase_gambia(root: Path):
    ds, A, pa = gambia_data()
    N = A.shape[0]
    cfg = gambia_config(N)
    trainer = Trainer(cfg, dataset=ds, adj_merge=A, adj_pa=pa,
                      experiments_root=str(root / "gambia"), device="cuda")
    cheb_sat.launches = 0
    loss0 = trainer.train_epoch(0)
    steps = trainer.last_epoch_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1 = trainer.train_epoch(1)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / trainer.last_epoch_steps * 1e3
    launches = cheb_sat.launches
    check(steps == 3, f"expected 3 GAMBIA steps per epoch, got {steps}")
    check(math.isfinite(loss0) and math.isfinite(loss1), f"GAMBIA losses {loss0}, {loss1}")
    check(launches == 2 * steps * cfg.training.nb_block,
          f"GAMBIA cheb_sat launches {launches} != {2 * steps} steps x 2 blocks")
    out = {"path": "gambia_dense_bf16", "device": torch.cuda.get_device_name(0),
           "N": N, "train_losses": [loss0, loss1],
           "launches": launches, "steps": 2 * steps, "ms_per_step_epoch2": ms_step}
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

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", action="store_true",
                    help="also time epochs with the kernel and the plain path")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every phase's numbers to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()

    report = build.build(build.SOURCES)
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f} s", flush=True)
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"card: {card}", flush=True)

    rows = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        pems = phase_pems08(root)
        measured = measure_pems08_epochs(root) if args.measure else None
        gambia = phase_gambia(root)
        if args.measure:
            measured = {"pems08": measured, "gambia": measure_gambia_steps(root),
                        "accuracy": measure_accuracy(root)}

    main_row = next(r for r in rows if r["shape"] == "pems08_blocks2-4")
    kernels = [{
        "name": "cheb_sat", "route": "cuda",
        "source": "dstagnn_drought_tpu_torch/csrc/cheb_sat.cu",
        "replaces": "dstagnn_drought_tpu/ops/pallas/cheb_sat.py:83",
        "launches": pems["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": "B=64 K=3 N=170 M=384 (PEMS08 blocks 2-4)",
        "launches_gambia": gambia["launches"],
    }]
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card, "cheb_sat": rows, "pems08": pems, "measure": measured,
            "gambia": gambia, "kernels": kernels,
            "seconds": time.perf_counter() - t_start,
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
