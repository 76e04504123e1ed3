"""Tracing and profiling: device traces, per-step timing, memory statistics.

The port's copy of ``amuse_tpu/utils/profiling.py``: ``device_trace`` runs
``torch.profiler`` around a block and writes its trace into a directory
(``tensorboard_trace_handler``'s Chrome-trace JSON); ``StepTimer`` aggregates
per-phase wall-clock times with p50/p95; ``memory_stats`` reads
``torch.cuda.memory_stats`` of one device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir, device="cuda"):
    """Trace the block with torch.profiler (host, and the card's kernels when
    ``device`` is CUDA); the trace is written into ``log_dir`` when the block
    ends. Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


class StepTimer:
    """Per-phase wall-clock aggregation with p50/p95 reporting."""

    def __init__(self):
        self._samples = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:30s} n={s['count']:<6d} mean={s['mean_ms']:8.2f}ms "
                f"p50={s['p50_ms']:8.2f}ms p95={s['p95_ms']:8.2f}ms"
            )
        return "\n".join(lines)


def memory_stats(device="cuda") -> dict:
    """The caching allocator's statistics of a CUDA device (bytes and counts,
    ``torch.cuda.memory_stats``); {} for the CPU, which keeps none."""
    dev = torch.device(device)
    return dict(torch.cuda.memory_stats(dev)) if dev.type == "cuda" else {}
