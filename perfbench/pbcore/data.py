"""Seeded inputs of a cell: the signal, its windows and the two graphs.

One general generator, driven by the configuration's ``data`` section (the
signal: ``generator`` names ``perfbench/signals/<generator>.py``, the rest
is its shape) and the traffic file's ``graph`` section (``kind`` names
``perfbench/graphs/<kind>.py``, ``params`` its parameters). A new signal or
graph is a new file there, found by name. Everything is numpy on the host
and made in bulk; the same seed gives the same arrays.

Frozen copies, kept here so that the yardstick does not move with the
program's benchmarks: the ``pa`` plane is the 1%-random mask with a unit
diagonal of ``benchmarks/gambia_bench.py`` (line 140, commit f33e1d7);
``windows`` is that file's ``windows`` (lines 83-100) generalised to any
input and horizon length: one label a step, 60/20/20 in time, inputs
z-scored per feature with the training split's statistics, targets the raw
feature 0 (the reference's ``prepareData.py``).
"""
from __future__ import annotations

import numpy as np

from pbcore.layers import module


def pa_plane(rng: np.random.Generator, n: int, density: float) -> np.ndarray:
    """The STRG plane ``adj_pa``: a ``density`` share of random entries and
    a unit diagonal (what a top-1% STAG sparsification keeps)."""
    pa = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(pa, 1.0)
    return pa


def windows(sig: np.ndarray, len_input: int, num_for_predict: int, split=(0.6, 0.2)):
    """(steps, N, F) → train/val/test of x (S, N, F, T) z-scored with the
    training split's per-feature statistics and y (S, N, P) raw feature 0,
    one window a label step."""
    steps, n, f = sig.shape
    s = steps - len_input - num_for_predict + 1
    n_tr, n_va = int(s * split[0]), int(s * split[1])
    # the training windows' statistics from the signal: step t lies in
    # count[t] of them
    count = np.convolve(np.ones(n_tr), np.ones(len_input))[:steps]
    count = np.pad(count, (0, max(0, steps - len(count))))[:steps]
    sums = sig.sum(axis=1, dtype=np.float64)                        # (steps, F)
    squares = (sig.astype(np.float64) ** 2).sum(axis=1)
    total = n_tr * n * len_input
    mean = (count @ sums) / total
    std = np.sqrt(np.maximum((count @ squares) / total - mean ** 2, 0.0)) + 1e-8
    norm = ((sig - mean) / std).astype(np.float32)
    mean, std = mean.reshape(1, 1, f, 1), std.reshape(1, 1, f, 1)
    # (s, N, F, len_input) windows of the normalised signal
    xn = np.lib.stride_tricks.sliding_window_view(norm, len_input, axis=0)[:s]
    y = np.lib.stride_tricks.sliding_window_view(sig[:, :, 0], num_for_predict, axis=0)
    y = np.ascontiguousarray(y[len_input:len_input + s], dtype=np.float32)
    parts = (slice(0, n_tr), slice(n_tr, n_tr + n_va), slice(n_tr + n_va, s))
    return {name: (np.ascontiguousarray(xn[p]), y[p])
            for name, p in zip(("train", "val", "test"), parts)}, mean, std


def make_inputs(seed: int, data: dict, graph: dict) -> dict:
    """Every input of a run from ``seed``: the windowed splits, the graph
    the conv runs on (``adj``) and ``adj_pa``. Signal, graph and plane take
    streams of their own, so a traffic file that changes the graph leaves
    the signal alone."""
    sig_rng, graph_rng, pa_rng = (np.random.default_rng([seed, k]) for k in (0, 1, 2))
    kind = data["generator"]
    shape = {k: v for k, v in data.items()
             if k not in ("generator", "len_input", "num_for_predict", "pa_density")}
    sig = module("signals", kind).make(sig_rng, **shape)
    n = sig.shape[1]
    adj = module("graphs", graph["kind"]).make(n, rng=graph_rng,
                                               **{**shape, **graph.get("params", {})})
    splits, mean, std = windows(sig, data["len_input"], data["num_for_predict"])
    return {"splits": splits, "mean": mean, "std": std, "adj": adj,
            "adj_pa": pa_plane(pa_rng, n, data["pa_density"])}
