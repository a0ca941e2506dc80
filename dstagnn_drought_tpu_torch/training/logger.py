"""Structured metric logging: JSONL on disk + stdout lines + TensorBoard.

Counterpart of ``dstagnn_drought_tpu/training/logger.py``. With
``tensorboard_dir`` every numeric field of every event also lands as a
scalar series ``<event>/<field>``, keyed by the event's ``epoch`` or, where
it has none, by how many times the event was logged before. ``echo=False``
keeps the stdout lines off (the ranks of a mesh other than rank 0, which
log nothing). The writer is
``tensorboardX``, optional as in JAX: without it the logger prints
"tensorboard logging disabled: ..." and the JSONL still works.
"""
from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, path: str | None = None, tensorboard_dir: str | None = None,
                 echo: bool = True):
        self._echo = echo
        self._file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")
        self._t0 = time.time()
        self._tb = None
        self._counts: dict[str, int] = {}
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError as exc:  # optional dependency: JSONL still works
                print(f"tensorboard logging disabled: {exc}", file=sys.stdout)

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._tb is not None:
            step = fields.get("epoch")
            if step is None:
                step = self._counts.get(event, 0)
                self._counts[event] = step + 1
            for k, v in fields.items():
                if k != "epoch" and isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{event}/{k}", v, int(step))
        if not self._echo:
            return
        kv = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in fields.items()
        )
        print(f"[{event}] {kv}", file=sys.stdout, flush=True)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
