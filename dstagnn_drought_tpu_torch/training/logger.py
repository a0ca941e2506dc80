"""Structured metric logging: JSONL on disk + stdout lines.

Counterpart of ``dstagnn_drought_tpu/training/logger.py`` without the
TensorBoard writer (not ported yet; the trainer refuses ``tensorboard``).
"""
from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, path: str | None = None):
        self._file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time() - self._t0, 3), **fields}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        kv = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in fields.items()
        )
        print(f"[{event}] {kv}", file=sys.stdout, flush=True)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
