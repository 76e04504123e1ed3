"""The program's span recorder: spans of its layers, per-phase timing.

``StepTimer.phase(name)`` records a span (``Span``) and its duration, and
``summary()``/``report()`` aggregate the durations with p50/p95, as the
JAX package's ``amuse_tpu/utils/profiling.py`` does. The layers open their
spans with the module-level ``span(name)``, which records into the recorder
that ``recording()`` makes active for its block and does nothing otherwise.

Spans stay in memory. Their ends are stamped in integer ns with
``time.time_ns()``, the Unix clock that ``torch.profiler``'s kineto records
carry (host operators, and on a card the CUDA runtime calls that CUPTI
records), so a span, the runtime call that launched a device operation and
the operation itself lie on one timeline.

Single-threaded: spans are opened only on the thread that runs the model.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np


@dataclass(slots=True)
class Span:
    """One recorded span: ``parent`` is the index of the innermost span open
    when it began (-1 for a root), ``request`` the id its root opened."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int


class StepTimer:
    """Per-phase wall-clock aggregation with p50/p95 reporting; each
    ``phase`` also records a ``Span`` into ``spans`` (in the order the spans
    began, so a parent precedes its children)."""

    def __init__(self):
        self._samples = defaultdict(list)
        self.spans: list[Span] = []
        self._open: list[int] = []
        self._requests = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        if self._open:
            parent = self._open[-1]
            request = self.spans[parent].request
        else:
            parent, request = -1, self._requests
            self._requests += 1
        index = len(self.spans)
        start = time.time_ns()
        self.spans.append(Span(name, start, start, parent, request))
        self._open.append(index)
        try:
            yield
        finally:
            end = time.time_ns()
            self._open.pop()
            self.spans[index].end_ns = end
            self._samples[name].append((end - start) * 1e-9)

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


_ACTIVE: StepTimer | None = None
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """Make a fresh ``StepTimer`` the active recorder for the block; yields it."""
    global _ACTIVE
    timer = StepTimer()
    previous, _ACTIVE = _ACTIVE, timer
    try:
        yield timer
    finally:
        _ACTIVE = previous


def span(name: str):
    """A span of the active recorder; with none active, one shared context
    that does nothing."""
    return _OFF if _ACTIVE is None else _ACTIVE.phase(name)


def request_span(name: str):
    """A root span: ``span(name)`` unless a span is open already (an entry
    point called from inside another opens no second request)."""
    return _OFF if _ACTIVE is None or _ACTIVE._open else _ACTIVE.phase(name)
