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
the reference put in the program's place (``fault_reading``). For each
exchange seed (a cell on several cards): the program with the exchange
between its ranks left out (its system's ``exchange_left_out``). One JSON
line per reading; ``--out`` also appends them to a file as they come.

A cell on several cards takes its program and exchange readings as the
ranks of a process group, one a card (``ranks.py``); rank 0 alone takes
the readings of the reference, and reports. Without those two kinds the
readings run in this process on one card.
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

from portbench import manifest, ranks  # noqa: E402

RANKS_TIMEOUT_S = 3400.0


def _system(cell):
    return importlib.import_module(f"portbench.systems.{cell.system}")


def program_reading(cell, seed: int, device: torch.device) -> dict | None:
    """The run's check over the requests it compares, for ``seed`` (None on
    a rank that does not check)."""
    sut = _system(cell).Session(cell.config, cell.traffic, cell.settings, seed, device)
    done = [sut.request(r) for r in sut.check_requests()]
    sut.release()
    return sut.check(done)


def control_reading(cell, seed: int, device: torch.device) -> dict:
    return _system(cell).control_reading(cell, seed, device)


def fault_reading(cell, seed: int, device: torch.device) -> dict:
    return _system(cell).fault_reading(cell, seed, device)


def exchange_reading(cell, seed: int, device: torch.device) -> dict | None:
    with _system(cell).exchange_left_out():
        return program_reading(cell, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="a training cell's planted fault (its system's fault_reading)")
    p.add_argument("--exchange-seeds", type=int, nargs="*", default=[],
                   help="a cell on several cards: the program with its exchange left out")
    p.add_argument("--out", default=None)
    p.add_argument("--launched-at", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cell = manifest.cell(Path(__file__).resolve().parents[1], args.workload)
    collective = cell.chips > 1 and bool(args.program_seeds or args.exchange_seeds)
    cards = cell.chips if collective else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"portbench.control: these readings of {args.workload} need {cards} CUDA "
              "card(s)", file=sys.stderr)
        return 2
    if collective and args.launched_at is None:
        own = list(sys.argv[1:] if argv is None else argv)
        out = ranks.launch([str(Path(__file__).resolve()), *own, "--launched-at",
                            repr(time.perf_counter())], cell.chips, RANKS_TIMEOUT_S)
        for line in out.stdout[0]:
            print(line, flush=True)
        return out.rc
    if collective:
        device, group, _ = ranks.join("cuda")
    else:
        device, group = torch.device("cuda", 0), ranks.Solo()
    # (kind, seeds, reading, whether every rank takes part)
    kinds = (("program", args.program_seeds, program_reading, True),
             ("control", args.control_seeds, control_reading, False),
             ("fault", args.fault_seeds, fault_reading, False),
             ("exchange", args.exchange_seeds, exchange_reading, True))
    for kind, seeds, fn, everywhere in kinds:
        for seed in seeds:
            t0 = time.perf_counter()
            values = fn(cell, seed, device) if everywhere or group.rank == 0 else None
            group.barrier()
            torch.cuda.empty_cache()
            if group.rank != 0:
                continue
            line = {"workload": args.workload, "kind": kind, "seed": seed, **values,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    if collective:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
