"""Checkpoints: ``torch.save`` files with a JSON metadata sidecar.

Port of ``amuse_tpu/train/checkpoint.py`` on ``torch.save``: step ``s`` lives
in ``<dir>/step_<s:08d>/state.pt`` beside ``metadata.json`` (``{"step",
"metrics"}``), and "best" selection reads the metadata. The port does not
read the JAX package's orbax checkpoints (a ``state/`` directory): the root
script ``orbax_to_torch.py``, run where the JAX package is installed,
converts such a directory into this layout (``ORBAX_HINT``), and the
converted directory then loads like one the port wrote. In a data-parallel
run (``mesh``) rank 0 alone writes and every rank waits at a barrier after
each save, so no rank reads a half-written ``state.pt``; every rank
restores from the same file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import torch

from amuse_tpu_torch.parallel.mesh import barrier, is_main


ORBAX_HINT = ("Convert the run where the JAX package is installed: python orbax_to_torch.py "
              "--src <jax run>/checkpoints --dst <port run>/checkpoints")


class CheckpointManager:
    """Step-indexed checkpoints of state dicts + JSON metadata."""

    def __init__(self, directory, mesh=None):
        self.directory = Path(directory).resolve()
        self.mesh = mesh
        if is_main(mesh):
            self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def save(self, step: int, state: dict, metrics: Optional[dict] = None) -> Path:
        """Write ``state`` (rank 0 of a mesh only), then wait for every rank."""
        path = self._path(step)
        if is_main(self.mesh):
            path.mkdir(parents=True, exist_ok=True)
            torch.save(state, path / "state.pt")
            meta = {"step": int(step), "metrics": _jsonable(metrics or {})}
            (path / "metadata.json").write_text(json.dumps(meta, indent=1))
        barrier(self.mesh)
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
                    f"reads only its own torch.save checkpoints. {ORBAX_HINT}")
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


def load_optimizer(optimizer: torch.optim.Optimizer, saved: Optional[dict]) -> None:
    """``saved`` (an optimizer state dict, or None for none) into
    ``optimizer``: the moments, each parameter's ``step`` and the learning
    rate are the saved ones; the hyperparameters (betas, eps, weight decay)
    and the implementation (``fused``, ``foreach``) stay the optimizer's
    own, as in the JAX package, whose optimizer state holds only the
    learning rate. So a state saved on another device, or converted from a
    JAX run, resumes fused on the card, with each ``step`` moved to its
    parameter's device as fused Adam wants."""
    if saved is None:
        return
    own = optimizer.state_dict()["param_groups"]
    groups = [{**o, "lr": g["lr"], "params": g["params"]}
              for g, o in zip(saved["param_groups"], own, strict=True)]
    optimizer.load_state_dict({**saved, "param_groups": groups})


def restore_train_state(directory, state, label: str) -> tuple[Any, int]:
    """Load the latest checkpoint under ``directory`` into ``state`` (an object
    with ``load_state_dict``: parameters, optimizer moments and step) ->
    (state, start_epoch). A checkpoint of bare parameters (converted from
    a JAX checkpoint older than the full train state) restores the
    parameters only, with the JAX package's loud line: the moments restart."""
    restored, meta = CheckpointManager(directory).restore()
    state.load_state_dict(restored)
    if "optimizer" in restored:
        what = "full train state (params + optimizer)"
    else:
        what = "params ONLY (old checkpoint format; optimizer moments reset)"
    start_epoch = int(meta.get("step", 0))
    print(f"[{label}] resumed {what} from {directory} at epoch {start_epoch}")
    return state, start_epoch


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = str(v)
    return out
