"""Metrics logging: one JSON line per record, and W&B when it imports.

Counterpart of ``fit_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    """Appends ``{"step", "time", **metrics}`` records to
    ``<directory>/<run_name>_metrics.jsonl``."""

    def __init__(self, directory: str, run_name: str = "fit", use_wandb: bool = False,
                 wandb_project: str = "FiT", wandb_run_id: Optional[str] = None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None  # not installed: JSONL only
            if wandb is not None:
                self._wandb = wandb.init(project=wandb_project, name=run_name, resume="allow", id=wandb_run_id)

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "time": time.time() - self._t0}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
