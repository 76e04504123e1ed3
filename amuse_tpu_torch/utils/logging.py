"""Run logging: one JSON record per line in ``<run_dir>/metrics.jsonl``, and wandb.

Port of ``amuse_tpu/utils/logging.py``: a local JSONL stream that survives
offline runs; wandb attaches when it is importable and ``WANDB_API_KEY`` is
set. ``RunLogger(None)`` (debug runs) writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional


class RunLogger:
    def __init__(self, run_dir: Optional[Path]):
        self.path = Path(run_dir) / "metrics.jsonl" if run_dir else None
        self._wandb = None
        if run_dir and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
            except ImportError:
                return
            wandb.init(project="amuse-tpu", dir=str(run_dir))
            self._wandb = wandb

    def log(self, step: int, metrics: dict) -> None:
        if self.path:
            record = {"step": int(step), "time": time.time(), **metrics}
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._wandb:
            self._wandb.log(metrics, step=step)
