"""The program's layer spans read against a device trace.

A session over a slice of requests records the device alone, as
``trace.traced`` does, while the program records its spans
(``amuse_tpu_torch.utils.profiling.recording``), stamped on the clock of the
profiler's records. A device-only session also holds the CUDA API calls
(``cuda*``, ``cu*``), each linked to the operations it launched by its
correlation id. So each device operation is put in the innermost span open
when its launching call began (``LinkedTrace.by_span``), and each idle gap
of the busy union in the innermost span open on the host when it opened
(``LinkedTrace.idle_by_span``). What no span holds is ``OUTSIDE`` (the
harness's own copies and initial latents), and an operation no call is
linked to is ``UNLINKED``; with them the parts sum to the slice.

The readers give device ms, idle ms and launches a request of the named
spans (a span holds the spans nested in it), and ``table`` the whole
partition. ``METRICS`` names the per-layer metrics they are meant to feed,
by the cell that reports each. ``tools/span_report.py`` runs a cell's slice
through ``cell_pass`` on a card and prints them.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from portbench import trace as tracing

OUTSIDE = "outside the program"
UNLINKED = "no launch record"

# metric -> (cell, reader, the spans it reads)
METRICS = {
    "fbank_ms.b32": ("infer.b32", "device_ms", ("infer.fbank",)),
    "ast_ms.b32": ("infer.b32", "device_ms", ("infer.ast",)),
    "decode_ms.b32": ("infer.b32", "device_ms", ("infer.decode",)),
    "launches.clips": ("infer.clips", "launches", ("infer.request",)),
    "ast_idle_ms.clips": ("infer.clips", "idle_ms", ("infer.ast",)),
    "decode_idle_ms.clips": ("infer.clips", "idle_ms", ("infer.decode",)),
    "copy_idle_ms.clips": ("infer.clips", "idle_ms", ("infer.upload", "infer.download")),
    "forward_ms.q8": ("stage1.q8", "device_ms", ("train.encode", "train.reconstruct",
                                                 "train.loss")),
    "backward_ms.q8": ("stage1.q8", "device_ms", ("train.backward",)),
}


@dataclass
class LinkedTrace(tracing.Trace):
    """A ``Trace`` whose device operations keep their correlation ids
    (``links``, in the order of ``device``), with the start of the runtime
    call recorded under each id (``launched_ns``)."""

    links: list = field(default_factory=list)
    launched_ns: dict = field(default_factory=dict)

    def slice_ops(self) -> list[tuple[int, float]]:
        """(index in ``device``, seconds inside the slice) of each device
        operation that overlaps the slice."""
        return [(i, min(e, self.end) - max(s, self.start))
                for i, (_, s, e) in enumerate(self.device) if e > self.start and s < self.end]

    def launch_owners(self, spans) -> list:
        """For each device operation, the index in ``spans`` of the innermost
        span open when the runtime call that launched it began, -1 where
        none was, None where no call is linked to it. ``spans`` are the
        recorder's, in the order they began."""
        starts = [sp.start_ns for sp in spans]
        return [None if self.launched_ns.get(c) is None
                else _innermost(spans, starts, self.launched_ns[c]) for c in self.links]

    def idle_owners(self, spans) -> list[tuple[float, int]]:
        """(seconds, index in ``spans`` or -1) of each idle gap of the busy
        union inside the slice, put in the innermost span open on the host
        when the gap opened."""
        edges = [self.start] + [x for iv in self.busy_intervals() for x in iv] + [self.end]
        starts = [sp.start_ns for sp in spans]
        return [(ge - gs, _innermost(spans, starts, round(gs * 1e9)))
                for gs, ge in zip(edges[0::2], edges[1::2]) if ge > gs]

    def by_span(self, spans) -> dict[str, float]:
        """Device seconds inside the slice by the innermost span open at each
        operation's launch (``OUTSIDE``, ``UNLINKED`` for the rest): the
        parts sum to the slice's device time."""
        owners = self.launch_owners(spans)
        total: dict[str, float] = defaultdict(float)
        for i, seconds in self.slice_ops():
            total[owner_name(spans, owners[i])] += seconds
        return dict(total)

    def idle_by_span(self, spans) -> dict[str, float]:
        """Idle seconds inside the slice by the innermost span open on the
        host when each gap opened (``OUTSIDE`` for the rest)."""
        total: dict[str, float] = defaultdict(float)
        for seconds, owner in self.idle_owners(spans):
            total[owner_name(spans, owner)] += seconds
        return dict(total)


@dataclass
class SpanTrace:
    """The program's spans over a traced slice of ``requests`` requests, and
    the slice's ``LinkedTrace``."""

    spans: list
    trace: LinkedTrace
    requests: int


def _innermost(spans, starts: list, t_ns: int) -> int:
    """The index of the innermost span open at ``t_ns``, or -1. Spans nest
    (one thread opens them), so every span open at ``t_ns`` that began
    before the last one to begin is among that one's ancestors."""
    i = bisect.bisect_right(starts, t_ns) - 1
    while i >= 0 and spans[i].end_ns <= t_ns:
        i = spans[i].parent
    return i


def owner_name(spans, owner) -> str:
    return UNLINKED if owner is None else OUTSIDE if owner < 0 else spans[owner].name


def within(spans, owner, names) -> bool:
    """Whether span ``owner`` (an index, -1 or None) is one of ``names`` or
    lies inside one."""
    while owner is not None and owner >= 0:
        if spans[owner].name in names:
            return True
        owner = spans[owner].parent
    return False


def _read(prof) -> LinkedTrace:
    """``trace._read``'s records, with the links of the device operations."""
    import torch

    out = LinkedTrace(**vars(tracing._read(prof)))
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():  # as trace._read walks them
        if ev.device_type() == cuda:
            if tracing.SENTINEL not in ev.name() and not ev.is_user_annotation():
                out.links.append(ev.correlation_id())
        elif ev.name().startswith("cu") and ev.correlation_id():  # a CUDA API call
            c, ns = ev.correlation_id(), ev.start_ns()
            out.launched_ns[c] = min(ns, out.launched_ns.get(c, ns))
    return out


def traced_spans(work, counts, device, requests: int = 1) -> SpanTrace | None:
    """``work()`` (``requests`` requests) in a session shaped as
    ``trace.traced``'s, the device alone recorded, while the program records
    its spans -> the ``SpanTrace``; None for a program without a span
    recorder. On a CPU device the host alone is recorded, so no device
    operation comes back."""
    try:
        from amuse_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    short = ""
    for _ in range(tracing.TRIES):
        box, recorders = [], []
        before = counts()
        with profile(activities=activities, on_trace_ready=lambda p: box.append(_read(p)),
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            if cuda:
                tracing._sentinels()
            prof.step()
            if cuda:
                tracing._sentinels()
            time.sleep(tracing.EDGE_S)
            if cuda:
                tracing._sentinels()
            with record_function(tracing.SLICE):
                if cuda:
                    torch.cuda._sleep(1)
                with recording() as rec:
                    recorders.append(rec)
                    work()
                if cuda:
                    torch.cuda.synchronize(device)
                    torch.cuda._sleep(1)
            if cuda:
                torch.cuda.synchronize(device)
            time.sleep(tracing.EDGE_S)
            prof.step()
        after = counts()
        short = tracing.short_records(box[0], {k: after[k] - before[k] for k in after})
        if not short:
            return SpanTrace(recorders[-1].spans, box[0], requests)
        print(f"profiler: a session came back short: {short}", file=sys.stderr)
    raise RuntimeError(f"the profiler came back short in {tracing.TRIES} sessions: {short}")


def cell_pass(sut, requests: list, device) -> SpanTrace | None:
    """A system's session ``sut`` runs ``requests`` once untraced, then in
    ``traced_spans``."""
    def run():
        for r in requests:
            sut.request(r)

    run()
    sut.finish()
    return traced_spans(run, sut.counts, device, len(requests))


def _has_device(got: SpanTrace | None) -> bool:
    return got is not None and bool(got.trace.device) and got.requests > 0


def device_ms(got: SpanTrace | None, *names):
    """Device ms a request of the slice's operations launched inside the
    named spans (or inside a span nested in one); None with no device
    operation to read."""
    if not _has_device(got):
        return None
    owners = got.trace.launch_owners(got.spans)
    seconds = sum(d for i, d in got.trace.slice_ops() if within(got.spans, owners[i], names))
    return 1e3 * seconds / got.requests


def idle_ms(got: SpanTrace | None, *names):
    """Device idle ms a request of the slice's gaps that opened while the
    host was inside the named spans."""
    if not _has_device(got):
        return None
    seconds = sum(d for d, owner in got.trace.idle_owners(got.spans)
                  if within(got.spans, owner, names))
    return 1e3 * seconds / got.requests


def launches(got: SpanTrace | None, *names):
    """Device operations a request launched inside the named spans."""
    if not _has_device(got):
        return None
    owners = got.trace.launch_owners(got.spans)
    count = sum(1 for i, _ in got.trace.slice_ops() if within(got.spans, owners[i], names))
    return count / got.requests


def metrics(got: SpanTrace | None, cell: str) -> dict:
    """``METRICS`` of ``cell`` that have something to read."""
    readers = {"device_ms": device_ms, "idle_ms": idle_ms, "launches": launches}
    values = {name: readers[how](got, *names)
              for name, (where, how, names) in METRICS.items() if where == cell}
    return {k: v for k, v in values.items() if v is not None}


def table(got: SpanTrace) -> dict:
    """Every span name with its own device ms, idle ms and launches a request
    (an operation or a gap counts for the innermost span only, so the rows,
    ``OUTSIDE`` and ``UNLINKED`` among them, sum to the slice), the slice's
    device ms a request and the share of it launched inside some span."""
    spans, trace = got.spans, got.trace
    n = max(got.requests, 1)
    device, idle = trace.by_span(spans), trace.idle_by_span(spans)
    owners = trace.launch_owners(spans)
    launched = Counter(owner_name(spans, owners[i]) for i, _ in trace.slice_ops())
    names = dict.fromkeys([sp.name for sp in spans] + list(device) + list(idle))
    rows = {k: {"device_ms": 1e3 * device.get(k, 0.0) / n, "idle_ms": 1e3 * idle.get(k, 0.0) / n,
                "launches": launched[k] / n} for k in names}
    total = sum(device.values())
    inside = total - device.get(OUTSIDE, 0.0) - device.get(UNLINKED, 0.0)
    return {"per_request": rows, "device_ms": 1e3 * total / n,
            "in_spans_pct": 100.0 * inside / total if total > 0 else None}
