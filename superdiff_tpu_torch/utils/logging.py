"""Observability: a local JSONL metric sink with optional wandb passthrough
(port of ``superdiff_tpu/utils/logging.py``: the same records, one JSON
object a line with ``ts``, ``step`` and the metrics)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, use_wandb: bool = False, **wandb_kw):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                wandb.init(**wandb_kw)

    def log(self, step: Optional[int] = None, **metrics) -> None:
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}), **metrics}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
