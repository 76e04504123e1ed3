"""The program's layer spans on a card: what the recorder
(``amuse_tpu_torch/utils/profiling.py``) costs, and where each cell's
device time and idle time go by span (``portbench/spans.py``).

Prints one JSON line with the host ns of one ``span()`` opened and closed
with no recorder active and with one active, then two lines a cell of
``BENCHMARK.json``. The first: the cell's traced slice (as many requests
as a ``--trace 1`` run traces) run untraced with the recorder off and on,
in turns (off, on, on, off, ...) after one of each, as ms a request and
the difference a request with its quartiles. The second: the same slice
in a device-only profiler session with the recorder on, as the span
metrics of ``portbench.spans.METRICS`` and the partition of the slice by
span (``spans.table``).

    python3 tools/span_report.py [--pairs 10] [--cells infer.b32 infer.clips stage1.q8]

It needs a CUDA card (the cells' kernels are built at first use).
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from amuse_tpu_torch.utils import profiling  # noqa: E402
from portbench import manifest, spans  # noqa: E402


def span_ns(n: int = 200_000) -> float:
    """Host ns of one span opened and closed, the least of three loops."""
    def loop() -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("x"):
                pass
        return (time.perf_counter_ns() - t) / n
    return min(loop() for _ in range(3))


def cell_report(name: str, pairs: int, seed: int, device: torch.device) -> tuple[dict, dict]:
    cell = manifest.cell(ROOT, name)
    system = importlib.import_module(f"portbench.systems.{cell.config['system']}")
    sut = system.Session(cell.config, cell.traffic, cell.settings, seed, device)
    reqs = [sut.traffic.request(10_000 + i) for i in range(int(cell.settings["trace"]["requests"]))]
    counted = []

    def run(on: bool) -> float:
        t = sut.finish()
        if on:
            with profiling.recording() as rec:
                for r in reqs:
                    sut.request(r)
            counted.append(len(rec.spans) / len(reqs))
        else:
            for r in reqs:
                sut.request(r)
        return (sut.finish() - t) * 1e3 / len(reqs)

    run(False)
    run(True)
    off, on = [], []
    for k in range(pairs):
        for state in ((False, True) if k % 2 == 0 else (True, False)):
            (on if state else off).append(run(state))
    diffs = [a - b for a, b in zip(on, off)]
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    got = spans.cell_pass(sut, reqs, device)
    sut.release()
    cost = {"cell": name, "requests": len(reqs), "pairs": pairs, "spans_a_request": counted[-1],
            "off_ms": statistics.median(off), "on_ms": statistics.median(on),
            "on_minus_off_ms": statistics.median(diffs), "q1": q1, "q3": q3}
    return cost, {"cell": name, "metrics": spans.metrics(got, name), "spans": spans.table(got)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--cells", nargs="*", default=["infer.b32", "infer.clips", "stage1.q8"])
    p.add_argument("--seed", type=int, default=2**31 + 1_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_report: no CUDA card", file=sys.stderr)
        return 2
    off = span_ns()
    with profiling.recording():
        on = span_ns()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "span_ns_off": off,
                      "span_ns_on": on}), flush=True)
    device = torch.device("cuda", 0)
    for k, name in enumerate(args.cells):
        for line in cell_report(name, args.pairs, args.seed + k, device):
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
