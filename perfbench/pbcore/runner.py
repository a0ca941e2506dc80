"""One run of one cell: find its files, make its inputs, build the program's
Trainer, drive its first steps and one validation pass as the warm-up,
measure whole epochs for the window, and hand the reference what it needs.

The window drives ``Trainer.train_epoch(e)`` then ``Trainer.evaluate("val")``
for e = 1, 2, ..., the body of ``Trainer.run`` without its checkpoints, and
starts no epoch once the window's seconds have passed. The warm-up is
epoch 0's first three steps and one validation pass: step 1 runs eagerly,
step 2 captures the training step's CUDA graph and step 3 replays it; the
validation pass captures the eval graph. The steps go through the same
epoch runner in two calls (the first step, the next two), so that the
first gradient (Adam's first moment after step 1) and the weights after
step 3 can be read between them. The rest of epoch 0 would only replay the
graph, so the warm-up leaves it out.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from pbcore import data as pb_data
from pbcore import shapes, state, trace

ROOT = Path(__file__).resolve().parents[1]       # perfbench/
REPO = ROOT.parent
FIRST_STEPS = 3


def load_cell(workload: str, manifest: Path | None = None) -> dict:
    """The cell's entry, its configuration file, its traffic file and its
    limits, found by name from ``BENCHMARK.json``."""
    bench = json.loads((manifest or REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    limits = ROOT / "limits" / f"{workload}.json"
    return {"cell": cell, "bench": bench,
            "config": json.loads((REPO / config["file"]).read_text()),
            "traffic": json.loads((ROOT / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads(limits.read_text()) if limits.exists() else None}


def port_config(cell: dict, seed: int):
    """The program's Config of the cell: the configuration's model, the
    traffic's knobs, the seed."""
    from dstagnn_drought_tpu_torch.config import Config, DataConfig, TrainingConfig

    m, knobs = cell["config"]["model"], cell["traffic"]["knobs"]
    data = DataConfig(num_of_vertices=m["num_of_vertices"], len_input=m["len_input"],
                      num_for_predict=m["num_for_predict"], points_per_hour=m["points_per_hour"],
                      dataset_name=cell["config"]["name"])
    keys = ("in_channels", "nb_block", "n_heads", "K", "d_k", "d_v", "d_model",
            "nb_chev_filter", "nb_time_filter", "time_strides", "batch_size", "learning_rate",
            "dropout", "num_of_hours", "graph")
    training = TrainingConfig(**{k: m[k] for k in keys}, **knobs, seed=seed,
                              compute_dtype=cell["config"]["dtype"], epochs=1)
    return Config(data=data, training=training).validate()


def set_tf32(config: dict) -> None:
    """The TF32 switches as the configuration states them."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"]["matmul"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"]["cudnn"])


def make_inputs(cell: dict, seed: int) -> dict:
    inputs = pb_data.make_inputs(seed, cell["config"]["data"], cell["traffic"]["graph"])
    knobs = cell["traffic"]["knobs"]
    tiled = knobs.get("sparse") and knobs.get("mask_format") == "tiles"
    inputs["tiles"] = state.Tiles(inputs["adj"], knobs["block_size"]) if tiled else None
    return inputs


def build(cell: dict, seed: int, inputs: dict, device, workdir: str):
    """(Trainer, the seeded initial state in the reference's layout)."""
    from dstagnn_drought_tpu_torch.data.dataset import ArrayDataset, Split
    from dstagnn_drought_tpu_torch.training.loop import Trainer

    s = inputs["splits"]
    ds = ArrayDataset(train=Split(*s["train"]), val=Split(*s["val"]), test=Split(*s["test"]),
                      mean=inputs["mean"], std=inputs["std"])
    trainer = Trainer(port_config(cell, seed), dataset=ds, adj_merge=inputs["adj"],
                      adj_pa=inputs["adj_pa"], experiments_root=workdir, device=device)
    state0 = state.initial_state(cell["config"]["model"], seed, device)
    program = state0
    if inputs["tiles"] is not None:
        program = state.masks_to_tiles(state0, inputs["tiles"], cell["config"]["model"]["K"])
    trainer.model.load_state_dict(program, strict=True)
    return trainer, state0


def _named(trainer, values: dict, tiles, base=None) -> dict:
    """{parameter name: tensor on the host} in the reference's layout (on
    BELL tiles, ``base``'s masks off the tile support)."""
    out = {name: values[p].detach().to("cpu", copy=True)
           for name, p in trainer.model.named_parameters()}
    return out if tiles is None else state.tiles_to_masks(out, tiles, base)


def warm_up(trainer, tiles, state0: dict) -> dict:
    """Epoch 0's first steps through the epoch runner, in two calls, then
    one validation pass. Returns the plan rows of the first steps, their
    losses, the first gradient (from Adam's first moment) and the weights
    after step 3, on the host in the reference's layout (``state0``'s
    masks off the BELL tile support, where the program holds none)."""
    idx, weights = trainer._train_plan(0)
    x_full, y_full = trainer._splits["train"]
    dev = x_full.device
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(dev)
    totals = weights.sum(dim=1)
    runner = trainer.runners()[0]
    parts, losses = [(0, 1), (1, FIRST_STEPS)], []
    params = dict(trainer.model.named_parameters())
    first_grad = after = None
    for a, b in parts:
        losses.append(runner(x_full, y_full, idx_t[a:b], weights[a:b], totals[a:b]))
        if b == 1:
            # a parameter that took no gradient has no Adam state
            opt, b1 = trainer.optimizer.state, trainer.optimizer.defaults["betas"][0]
            moment = {p: opt[p]["exp_avg"] / (1 - b1) if "exp_avg" in opt[p]
                      else torch.zeros_like(p) for p in params.values()}
            first_grad = _named(trainer, moment, tiles)
        elif b == FIRST_STEPS:
            after = _named(trainer, {p: p for p in params.values()}, tiles,
                           {k: v.cpu() for k, v in state0.items() if ".mask." in k})
    losses = torch.cat(losses).tolist()
    trainer.evaluate("val")
    return {"rows": idx[:FIRST_STEPS], "weights": weights[:FIRST_STEPS].cpu(),
            "losses": losses, "first_grad": first_grad, "after": after}


def window(trainer, seconds: float, traced: bool) -> dict:
    """Whole epochs (train, then validate) until ``seconds`` have passed;
    with ``traced`` under the profiler. Returns the record the readers
    take."""
    epochs = []
    n_train = len(trainer.dataset.train)
    n_val = len(trainer.dataset.val)
    val_batches = -(-n_val // trainer.cfg.training.batch_size)
    with trace.profiled(traced) as prof:
        with torch.profiler.record_function(trace.SPAN + "window"):
            t0 = time.perf_counter()
            e = 1
            while True:
                a = time.perf_counter()
                with torch.profiler.record_function(trace.SPAN + "train_epoch"):
                    trainer.train_epoch(e)          # reading the losses waits for the card
                b = time.perf_counter()
                with torch.profiler.record_function(trace.SPAN + "evaluate"):
                    pred, _ = trainer.evaluate("val")   # predictions on the host
                c = time.perf_counter()
                epochs.append({"train_s": b - a, "val_s": c - b,
                               "train_steps": trainer.last_epoch_steps,
                               "train_windows": n_train, "val_batches": val_batches,
                               "losses": list(trainer.last_losses)})
                e += 1
                if c - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    return {"epochs": epochs, "window_s": window_s, "val_pred": pred,
            "trace": trace.reduce(prof) if traced else None}


def run_record(cell: dict, measured: dict, inputs: dict, peaks: dict) -> dict:
    """The record every per-layer reader takes."""
    m = cell["config"]["model"]
    blocks = shapes.blocks(m, m["batch_size"])
    if inputs["tiles"] is not None:
        for b in blocks:
            b.update(A=inputs["tiles"].active, BS=inputs["tiles"].bs)
    ep = measured["epochs"]
    return {**measured, "blocks": blocks, "peaks": peaks,
            "dtype_bytes": {"float32": 4, "bfloat16": 2}[cell["config"]["dtype"]],
            "train_steps": sum(e["train_steps"] for e in ep),
            "val_batches": sum(e["val_batches"] for e in ep),
            "train_windows": sum(e["train_windows"] for e in ep)}


def graph_pool_free_bytes(trainer) -> int:
    """Bytes that the trainer's CUDA graph pool holds free between replays:
    the replays' activations and temporaries, which a replay writes without
    allocating, so the allocator's peak does not see them (the idea of
    chip_smoke.py's pool_free_mib, commit f33e1d7)."""
    pool = trainer.runners()[0].pool
    if pool is None:
        return 0
    pool = tuple(pool)
    return sum(b["size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool
               for b in seg["blocks"] if b["state"] == "inactive")


def execute(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
            peaks: dict) -> dict:
    """The whole run after the card's check: inputs, Trainer, warm-up, the
    window, the peak, then the reference's comparison once the program is
    freed. Returns the record (with ``setup_s``, ``peak_bytes`` and the
    compared ``numbers``)."""
    import gc
    import shutil
    import tempfile

    from pbcore import check

    spec = cell["config"]["model"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    workdir = tempfile.mkdtemp(prefix="perfbench-")   # under $TMPDIR
    try:
        marks = [("imports", time.perf_counter())]
        inputs = make_inputs(cell, seed)
        marks.append(("inputs", time.perf_counter()))
        trainer, state0 = build(cell, seed, inputs, device, workdir)
        marks.append(("trainer", time.perf_counter()))
        first = warm_up(trainer, inputs["tiles"], state0)
        del state0
        sync()
        marks.append(("warm-up", time.perf_counter()))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        setup_parts = {name: t - prev for (name, t), prev
                       in zip(marks, [t_start] + [t for _, t in marks[:-1]])}
        measured = window(trainer, seconds, traced)
        sync()
        peak = (torch.cuda.max_memory_allocated() + graph_pool_free_bytes(trainer)
                if cuda else 0)
        final = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}
        if inputs["tiles"] is not None:
            final = state.tiles_to_masks(final, inputs["tiles"])
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record = run_record(cell, measured, inputs, peaks)
    # the reference, once the window has closed and the program is freed
    state0 = state.initial_state(spec, seed, device)
    consts = check.constants(inputs, spec, device)
    numbers = check.first_steps(first, state0, check.batches(inputs, first, device), spec,
                                consts, spec["learning_rate"], device)
    del state0
    x_val = inputs["splits"]["val"][0]
    pick = check.val_sample(seed, len(x_val), cell["traffic"]["check"]["val_windows"])
    numbers["val_gap"] = check.val_gap(measured["val_pred"][pick], final, x_val[pick], spec,
                                       consts, device)
    return {**record, "setup_s": setup_s, "setup_parts": setup_parts, "peak_bytes": peak,
            "numbers": numbers}
