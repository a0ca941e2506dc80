"""Tracing and profiling — counterpart of
``dstagnn_drought_tpu/training/profiling.py``.

* ``trace(logdir)`` — a ``torch.profiler`` region over CPU and, where a
  card is present, CUDA activities; on exit it writes a Chrome trace
  (``trace.json``, viewable in Perfetto or chrome://tracing) into
  ``logdir``. The kernels of a CUDA graph's replays (the Trainer's
  graphed epochs) appear in it by name, one record a launch, as eager
  launches do; a replay has no host ops of its own.
* ``annotate`` — a named region in the trace (``record_function``).
* ``StepTimer`` — wall-clock step timing whose ``fence(x)`` synchronises
  x's device only at interval edges, with JAX's ``drop_first``.
* ``throughput`` — windows/s and edges/s/chip from a step time, with JAX's
  arithmetic: an edge is one aggregated (src→dst, order k, timestep)
  contribution, nnz(A) · K · T · batch per step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

annotate = record_function  # named host-side trace regions


@contextlib.contextmanager
def trace(logdir: str):
    """Host (and CUDA, with a card) trace of the enclosed region, written to
    ``<logdir>/trace.json`` on exit; yields the ``torch.profiler.profile``,
    whose ``key_averages()`` hold the region's sums after it. The caller
    synchronises the device inside the region where the work must be in
    the trace::

        with trace("/tmp/torchtrace") as prof:
            loss = trainer.train_epoch(0)  # reading the loss synchronises
        print(prof.key_averages().table(row_limit=10))
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(x) -> None:
    """Wait for the devices of every tensor in ``x`` (a tensor, or a list,
    tuple or dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _synchronize(v)
    elif isinstance(x, dict):
        for v in x.values():
            _synchronize(v)


@dataclasses.dataclass
class StepTimer:
    """Wall-clock step timing with explicit fence points.

    ``start()`` opens an interval without syncing; ``fence(x)`` waits for
    ``x``'s device and closes the open interval as one sample of elapsed /
    steps. With ``drop_first`` the first sample (the warm-up) is left out
    of the mean when there are more."""

    drop_first: bool = True
    _marks: list = dataclasses.field(default_factory=list)
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def fence(self, x, steps: int = 1):
        """Wait for device value ``x``; record elapsed/steps as one sample."""
        _synchronize(x)
        now = time.perf_counter()
        if self._t0 is not None:
            self._marks.append((now - self._t0) / steps)
        self._t0 = now

    @property
    def samples(self) -> list[float]:
        return self._marks[1:] if self.drop_first and len(self._marks) > 1 else self._marks

    def mean_step_seconds(self) -> float:
        s = self.samples
        return sum(s) / len(s) if s else float("nan")


def throughput(*, step_seconds: float, batch_size: int, nnz: int, K: int, T: int,
               n_chips: int = 1) -> dict:
    """Benchmark counters from a measured step time: windows/s and
    edges/s/chip (nnz · K · T · batch edges a step)."""
    windows_per_s = batch_size / step_seconds
    edges_per_step = nnz * K * T * batch_size
    return {
        "step_seconds": step_seconds,
        "windows_per_s": windows_per_s,
        "edges_per_s_per_chip": edges_per_step / step_seconds / n_chips,
    }
