"""Readings that a cell's limits are set from, at the cell's own size.

    python3 -m portbench.control --workload <cell> --program-seeds 1 2 ... --control-seeds 1 2 3

For each program seed: the cell's set-up as a run makes it, the requests
its check compares (an inference cell's first ``check.requests``; a
training cell's checked steps run in set-up), the program freed, and the
run's own check over them: the lower reading is the largest over the
seeds. For each control seed: the plain reference one precision step below
the configuration's in the program's place (its system's
``control_reading``), judged as a run judges the program: the upper reading
is the smallest. For each fault seed (a training cell): a fault planted in
the reference put in the program's place (``fault_reading``). One JSON
line per reading; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import manifest  # noqa: E402


def _system(cell):
    return importlib.import_module(f"portbench.systems.{cell.config['system']}")


def program_reading(cell, seed: int, device: torch.device) -> dict:
    """The run's check over the requests it compares, for ``seed``."""
    sut = _system(cell).Session(cell.config, cell.traffic, cell.settings, seed, device)
    done = [sut.request(r) for r in sut.check_requests()]
    sut.release()
    return sut.check(done)


def control_reading(cell, seed: int, device: torch.device) -> dict:
    return _system(cell).control_reading(cell, seed, device)


def fault_reading(cell, seed: int, device: torch.device) -> dict:
    return _system(cell).fault_reading(cell, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="a training cell's planted fault (its system's fault_reading)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = manifest.cell(Path(__file__).resolve().parents[1], args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines = []
    for kind, seeds, fn in (("program", args.program_seeds, program_reading),
                            ("control", args.control_seeds, control_reading),
                            ("fault", args.fault_seeds, fault_reading)):
        for seed in seeds:
            t0 = time.perf_counter()
            values = fn(cell, seed, device)
            line = {"workload": args.workload, "kind": kind, "seed": seed, **values,
                    "seconds": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
