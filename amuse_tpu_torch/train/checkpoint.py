"""Checkpoints: ``torch.save`` files with a JSON metadata sidecar.

Port of ``amuse_tpu/train/checkpoint.py`` on ``torch.save``: step ``s`` lives
in ``<dir>/step_<s:08d>/state.pt`` beside ``metadata.json`` (``{"step",
"metrics"}``), and "best" selection reads the metadata. The port cannot
read the JAX package's orbax checkpoints (a ``state/`` directory); it
raises saying so.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import torch


class CheckpointManager:
    """Step-indexed checkpoints of state dicts + JSON metadata."""

    def __init__(self, directory):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def save(self, step: int, state: dict, metrics: Optional[dict] = None) -> Path:
        path = self._path(step)
        path.mkdir(parents=True, exist_ok=True)
        torch.save(state, path / "state.pt")
        meta = {"step": int(step), "metrics": _jsonable(metrics or {})}
        (path / "metadata.json").write_text(json.dumps(meta, indent=1))
        return path

    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.directory.glob("step_*") if p.is_dir()
        )

    def metadata(self, step: int) -> dict:
        return json.loads((self._path(step) / "metadata.json").read_text())

    def restore(self, step: Optional[int] = None) -> tuple[Any, dict]:
        """Restore a step (default: the latest) -> (state dict on the CPU, metadata)."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._path(steps[-1] if step is None else step)
        if not (path / "state.pt").exists():
            if (path / "state").is_dir():
                raise NotImplementedError(
                    f"{path} is an orbax checkpoint of the JAX package; amuse_tpu_torch "
                    "reads only its own torch.save checkpoints (convert JAX parameters "
                    "with amuse_tpu_torch.convert.from_jax_params and save them with "
                    "CheckpointManager)")
            raise FileNotFoundError(f"no state.pt under {path}")
        state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        return state, self.metadata(int(path.name.split("_")[1]))

    def best_step(self, metric: str = "total", mode: str = "min") -> int:
        """The step whose recorded ``metric`` is least (``min``) or greatest
        (``max``); the latest step when no checkpoint recorded it."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        scored = [(m[metric], s) for s in steps
                  if metric in (m := self.metadata(s)["metrics"])]
        if not scored:
            return steps[-1]
        return (min(scored) if mode == "min" else max(scored))[1]


def restore_train_state(directory, state, label: str) -> tuple[Any, int]:
    """Load the latest checkpoint under ``directory`` into ``state`` (an object
    with ``load_state_dict``: parameters, optimizer moments and step) ->
    (state, start_epoch)."""
    restored, meta = CheckpointManager(directory).restore()
    state.load_state_dict(restored)
    start_epoch = int(meta.get("step", 0))
    print(f"[{label}] resumed full train state (params + optimizer) from {directory} "
          f"at epoch {start_epoch}")
    return state, start_epoch


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = str(v)
    return out
