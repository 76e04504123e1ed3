"""Run logging: one JSON record per line in ``<run_dir>/metrics.jsonl``.

Port of ``amuse_tpu/utils/logging.py`` without its optional wandb hook: the
port writes the local JSONL stream only. ``RunLogger(None)`` (debug runs)
writes nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class RunLogger:
    def __init__(self, run_dir: Optional[Path]):
        self.path = Path(run_dir) / "metrics.jsonl" if run_dir else None

    def log(self, step: int, metrics: dict) -> None:
        if self.path:
            record = {"step": int(step), "time": time.time(), **metrics}
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
