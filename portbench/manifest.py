"""Find a cell's files by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict  # workloads/<cell>.json: the check and the traced slice
    end_to_end: list  # the BENCHMARK.json metrics this cell reports, by kind
    per_layer: list

    @property
    def system(self) -> str:
        """The module of ``systems/`` that drives the cell: the settings'
        ``system`` where they name one, else the configuration's."""
        return self.settings.get("system", self.config["system"])


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str, pkg: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its config, traffic
    and settings read from ``pkg``; raises KeyError for an unknown cell."""
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    config = json.loads((pkg / "configs" / f"{entry['config']}.json").read_text())
    if config["name"] != entry["config"]:
        raise ValueError(f"configs/{entry['config']}.json names itself {config['name']!r}")
    traffic = json.loads((pkg / "traffic" / f"{entry['traffic']}.json").read_text())
    settings = json.loads((pkg / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                settings=settings,
                end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _reports(m, name)])


def reader(metric: str, pkg: Path = HERE) -> ModuleType:
    """The module ``metrics/<metric>.py`` (names may hold dots, so it is
    loaded by path)."""
    path = pkg / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
