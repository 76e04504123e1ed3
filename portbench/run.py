"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. It needs as many
CUDA cards as the cell asks for, and exits with another code than 0 without
a result where they are missing. Set-up (imports, CUDA init, the cell's
kernels, weights and audio drawn from the seed, warm-up of every request
size) is timed from the start of the process to the first timed request.
Then one closed-loop client sends the mix's requests for ``--seconds``.
With ``--trace 1`` a fixed slice of further requests runs once untraced
(the length the idle share is taken over), once with the device traced
(busy time, the device's operations, the per-layer metrics) and once with
the host traced too (the idle gaps named), and the result carries the
cell's per-layer metrics in place of its end-to-end ones. After the
window the program is freed and the plain reference checks a sample of the
window's requests; each number compared is printed beside its limit as
the last lines on standard error and as the last key of the result, the
last line on standard output.

A cell on N > 1 cards runs as N ranks of one process group on this host
(``ranks.py``): this process, which imports no torch, starts the ranks
with the ``env://`` variables at once, passes on the last lines of rank 0,
which alone checks and reports, and exits as the first rank that fails;
each rank exits with code 2 where it sees fewer than N cards. Set-up runs
from the start of this process to the first timed request, once every rank
is ready; it takes in the ranks' start and the process group's
(``stages``: ``spawn_s``, ``imports_s``, ``join_s``, ``first_collective_s``).
Rank 0 alone decides when the window ends, and every rank runs the same
requests. With ``--trace 1`` every rank traces the slice of its own card:
``device.busy_s`` sums the cards' busy time (the line gives it over
``count``), ``memory_peak_bytes`` is the fullest card's, the breakdown rank
0's.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(CHECKOUT))
# Python's bytecode of every module the run imports is cached inside the
# checkout, at a fixed path beside the kernels' build (build/amuse_tpu_torch),
# so that, as with the kernels, only a checkout's first run compiles it.
PYCACHE = CHECKOUT / "build" / "pycache"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "amuse_tpu")
# A cell on several cards: its ranks must all have ended by then (a first
# run builds the kernels, which a checkout's first run may take 1200 s for).
RANKS_TIMEOUT_S = 1150.0


@dataclass
class Window:
    start: float
    end: float
    done: list


@dataclass
class Context:
    """What the metric readers see."""

    cfg: dict
    setup_s: float
    window: Window
    chips: int = 1  # the cards the cell runs on
    trace: object = None  # trace.Trace of the traced slice
    counted: dict = field(default_factory=dict)  # launches counted in the slice
    slice_work: dict = field(default_factory=dict)  # {kernel: (flops, bytes)} of the slice
    slice_requests: list = field(default_factory=list)
    slice_untraced_s: float = 0.0  # the slice's requests run untraced, host clock
    slice_readings: dict = field(default_factory=dict)  # the session's own, of the traced slice


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, start: float,
             ranks=None) -> dict | None:
    """One run of ``cell`` on ``device`` -> the result (without ``device``);
    ``start`` is the host clock set-up is timed from. ``ranks`` is this
    process's ``ranks.Group`` in a cell on several cards (``ranks.Solo()``
    by default); every rank returns None but rank 0."""
    import torch

    from portbench import manifest
    from portbench import ranks as ranks_mod
    from portbench import trace as tracing

    ranks = ranks_mod.Solo() if ranks is None else ranks
    system = importlib.import_module(f"portbench.systems.{cell.system}")
    sut = system.Session(cell.config, cell.traffic, cell.settings, seed, device)
    ranks.barrier()
    t0 = time.perf_counter()
    setup_s = t0 - start
    deadline, done, index = t0 + seconds, [], 0
    while ranks.go(time.perf_counter() < deadline):
        done.append(sut.request(sut.traffic.request(index)))
        index += 1
    window = Window(t0, sut.finish(), done)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    peak = max(ranks.gather(peak))
    ctx = Context(cell.config, setup_s, window, chips=cell.chips)
    if trace:
        slice_requests = [sut.traffic.request(index + i)
                          for i in range(int(cell.settings["trace"]["requests"]))]
        def run_slice():
            for r in slice_requests:
                sut.request(r)

        # the slice untraced: the length its device time is taken against
        t_slice = sut.finish()
        run_slice()
        ctx.slice_untraced_s = sut.finish() - t_slice
        ctx.trace = tracing.traced(run_slice, sut.counts, device, agree=ranks.agree)
        if hasattr(sut, "slice_readings"):
            ctx.slice_readings = sut.slice_readings(len(slice_requests))
        idle_gaps = tracing.traced(run_slice, sut.counts, device, host=True,
                                   agree=ranks.agree).idle_gaps()
        # the records of one slice; traced() holds them to the launches counted
        ctx.counted = {k: ctx.trace.kernel_records(k) // per
                       for k, (_, per) in tracing.KERNEL_RECORDS.items()}
        ctx.slice_work = sut.slice_flops(slice_requests)
        ctx.slice_requests = slice_requests
        busy_s = sum(ranks.gather(ctx.trace.busy_s))
    steps = ranks.gather(len(done))
    if len(set(steps)) != 1:
        raise RuntimeError(f"the ranks ran {steps} requests in the window")
    sut.release()
    ranks.barrier()  # every rank has freed the program before rank 0 checks
    t_check = time.perf_counter()
    values = sut.check(done)
    check_s = time.perf_counter() - t_check
    if ranks.rank != 0:
        return None
    limits = cell.settings["check"]["limits"]
    compared = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # a request that raises ends the run without a result, so none is failed
    result = {"correct": correct, "attempted": len(done), "failed": 0, "metrics": metrics,
              "memory_peak_bytes": peak}
    if trace:
        result["trace"] = {"busy_s": busy_s, "window_s": ctx.trace.window_s,
                           "breakdown": {"device_ops": ctx.trace.device_ops(),
                                         "idle_gaps": idle_gaps}}
    result["stages"] = {**getattr(sut, "stages", {}), "check_s": check_s}
    if trace:
        result["stages"].update(slice_untraced_s=ctx.slice_untraced_s, slice_s=ctx.trace.window_s)
    result["readings"] = {k: v for k, v in values.items() if k not in limits}
    if ranks.size > 1:
        result["rank_requests"] = steps
    result["compared"] = compared
    return result


def result_line(result: dict, device_info: dict) -> str:
    """The contract's last line: ``compared`` comes last."""
    out = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    out["device"] = {**device_info, "memory_peak_bytes": result["memory_peak_bytes"]}
    if "trace" in result:
        out["device"].update(busy_s=result["trace"]["busy_s"] / device_info["count"],
                             window_s=result["trace"]["window_s"])
        out["breakdown"] = result["trace"]["breakdown"]
    out["compared"] = result["compared"]
    return json.dumps(out)


def report(result: dict, device_info: dict) -> None:
    """The run's last lines: ``stages``, ``readings`` and each number
    compared beside its limit on standard error, the result on standard
    output."""
    print("stages " + " ".join(f"{k} {v:.3f}" for k, v in result["stages"].items()),
          file=sys.stderr)
    print("readings " + " ".join(f"{k} {v!r}" for k, v in result["readings"].items()),
          file=sys.stderr)
    if "rank_requests" in result:
        print("rank_requests " + " ".join(map(str, result["rank_requests"])), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result, device_info), flush=True)


def _refuse_forbidden() -> bool:
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
    return bool(found)


def launch_ranks(args, cell) -> int:
    """The cell's ranks, one a card, each this script with ``--launched-at``;
    rank 0's last lines passed on as this process's own."""
    from portbench import ranks

    argv = [str(Path(__file__).resolve()), "--workload", args.workload, "--seed",
            str(args.seed), "--seconds", repr(args.seconds), "--trace", str(args.trace),
            "--launched-at", repr(PROCESS_START)]
    out = ranks.launch(argv, cell.chips, RANKS_TIMEOUT_S)
    if out.rc != 0:
        who = "time ran out" if out.failed_rank is None else f"rank {out.failed_rank} failed"
        print(f"portbench: {who} (code {out.rc}); every rank has ended", file=sys.stderr)
        return out.rc
    line = out.stdout[0][-1] if out.stdout[0] else ""
    if not line.startswith("{") or _refuse_forbidden():
        print("portbench: rank 0 printed no result", file=sys.stderr)
        return 1
    for name, c in json.loads(line)["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


def run_rank(cell, seed: int, seconds: float, trace: bool, launched_at: float,
             device_type: str = "cuda") -> int:
    """One rank of a cell on several cards; ``launched_at`` is the host clock
    at which the launcher started (``perf_counter`` reads CLOCK_MONOTONIC,
    one clock for every process of a host)."""
    import torch

    from portbench import ranks

    spawn_s, imports_s = PROCESS_START - launched_at, time.perf_counter() - PROCESS_START
    device, group, stages = ranks.join(device_type)
    torch.set_num_threads(2)
    result = run_cell(cell, seed, seconds, trace, device, launched_at, group)
    if _refuse_forbidden():
        return 3
    if result is not None:
        result["stages"] = {"spawn_s": spawn_s, "imports_s": imports_s, **stages,
                            **result["stages"]}
        cuda = device.type == "cuda"
        report(result, {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                        "count": group.size})
    torch.distributed.destroy_process_group()
    return 0


def too_few_cards(workload: str, chips: int) -> bool:
    """Whether this process sees fewer CUDA cards than the cell asks for
    (said on standard error)."""
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"portbench: {workload} needs {chips} CUDA card(s); this process sees {seen}",
              file=sys.stderr)
    return seen < chips


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards: the host clock its launcher started at
    p.add_argument("--launched-at", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.pycache_prefix, sys.dont_write_bytecode = str(PYCACHE), False

    from portbench import manifest

    cell = manifest.cell(CHECKOUT, args.workload)
    if args.launched_at is not None and "WORLD_SIZE" in os.environ:
        if too_few_cards(args.workload, cell.chips):
            return 2
        return run_rank(cell, args.seed, args.seconds, bool(args.trace), args.launched_at)
    if cell.chips != 1:  # the ranks look for the cards; this process imports no torch
        return launch_ranks(args, cell)
    import torch

    if too_few_cards(args.workload, cell.chips):
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, PROCESS_START)
    if _refuse_forbidden():
        return 3
    report(result, {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                    "count": cell.chips})
    return 0


if __name__ == "__main__":
    sys.exit(main())
