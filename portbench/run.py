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
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
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
    trace: object = None  # trace.Trace of the traced slice
    counted: dict = field(default_factory=dict)  # launches counted in the slice
    slice_work: dict = field(default_factory=dict)  # {kernel: (flops, bytes)} of the slice
    slice_requests: list = field(default_factory=list)
    slice_untraced_s: float = 0.0  # the slice's requests run untraced, host clock


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, start: float) -> dict:
    """One run of ``cell`` on ``device`` -> the result (without ``device``);
    ``start`` is the host clock set-up is timed from."""
    import torch

    from portbench import manifest
    from portbench import trace as tracing

    system = importlib.import_module(f"portbench.systems.{cell.config['system']}")
    sut = system.Session(cell.config, cell.traffic, cell.settings, seed, device)
    t0 = time.perf_counter()
    setup_s = t0 - start
    deadline, done, index = t0 + seconds, [], 0
    while time.perf_counter() < deadline:
        done.append(sut.request(sut.traffic.request(index)))
        index += 1
    window = Window(t0, sut.finish(), done)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx = Context(cell.config, setup_s, window)
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
        ctx.trace = tracing.traced(run_slice, sut.counts, device)
        idle_gaps = tracing.traced(run_slice, sut.counts, device, host=True).idle_gaps()
        # the records of one slice; traced() holds them to the launches counted
        ctx.counted = {k: ctx.trace.kernel_records(k) // per
                       for k, (_, per) in tracing.KERNEL_RECORDS.items()}
        ctx.slice_work = sut.slice_flops(slice_requests)
        ctx.slice_requests = slice_requests
    sut.release()
    t_check = time.perf_counter()
    values = sut.check(done)
    check_s = time.perf_counter() - t_check
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
        result["trace"] = {"busy_s": ctx.trace.busy_s, "window_s": ctx.trace.window_s,
                           "breakdown": {"device_ops": ctx.trace.device_ops(),
                                         "idle_gaps": idle_gaps}}
    result["stages"] = {**getattr(sut, "stages", {}), "check_s": check_s}
    if trace:
        result["stages"].update(slice_untraced_s=ctx.slice_untraced_s, slice_s=ctx.trace.window_s)
    result["readings"] = {k: v for k, v in values.items() if k not in limits}
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.pycache_prefix, sys.dont_write_bytecode = str(PYCACHE), False

    from portbench import manifest

    cell = manifest.cell(CHECKOUT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this process "
              f"sees {seen}", file=sys.stderr)
        return 2
    if cell.chips != 1:
        print(f"portbench: {args.workload} asks for {cell.chips} cards; this harness drives "
              "one", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips}
    print("stages " + " ".join(f"{k} {v:.3f}" for k, v in result["stages"].items()),
          file=sys.stderr)
    print("readings " + " ".join(f"{k} {v!r}" for k, v in result["readings"].items()),
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result, info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
