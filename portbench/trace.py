"""The device trace of a traced slice: torch.profiler (CUPTI) over a fixed
amount of work, read into device intervals and host events.

The profiler has been seen to drop the first records of a recorded step
(``chip_smoke.py``'s sessions, PERF.md): a session therefore opens with a
warm-up step, and the recorded step with sentinel kernels and 0.1 s of
idle time before the work and as long after it. Every launch of the
program's kernels that its wrappers counted must come back as records
(``KERNEL_RECORDS``); a short session is run again, three times at most.

Busy time is the union of the device operations' intervals (kernels,
copies, sets) inside the slice, not their sum. The busy time, the slice
and the device's operations come from a session that records the device
alone (recording the host's operators too lengthened the device's busy
time by 3-4% where the device paces the work, PERF.md). Even so the
slice is longer than the same work untraced, by the profiler's cost on
the host, so the idle share is taken against the untraced length
(``readers.device_idle_pct``). A second session over the same work
records the host too and names the idle gaps by what the host was doing;
those gaps hold the profiler's slowing of the host.
"""

from __future__ import annotations

import bisect
import heapq
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

TRIES = 3
EDGE_S = 0.1
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel
SLICE = "portbench.slice"
# The program's kernels (in each source's anonymous namespace) by the
# starts of their names, and how many records one counted launch makes.
KERNEL_RECORDS = {
    "attention_fwd": (("attn_fwd",), 1),
    "attention_bwd": (("attn_bwd",), 3),
    "ddim_sampler": (("ddim_sampler_kernel",), 1),
}
NAME_CHARS = 160


def kernel_family(name: str) -> str | None:
    for family, (marks, _) in KERNEL_RECORDS.items():
        if any(f"(anonymous namespace)::{m}" in name for m in marks):
            return family
    return None


@dataclass
class Trace:
    """What one traced slice left: device operations as (name, start, end)
    in seconds, host events as (name, start, end), and the slice."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device intervals inside the slice, merged and sorted."""
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.device
                       if e > self.start and s < self.end)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, family: str) -> float:
        return sum(e - s for name, s, e in self.device if kernel_family(name) == family)

    def kernel_records(self, family: str) -> int:
        return sum(1 for name, _, _ in self.device if kernel_family(name) == family)

    def device_ops(self, top: int = 10) -> list:
        total: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            total[name[:NAME_CHARS]] += e - s
        return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time inside the slice, summed by what the host was doing when
        each gap opened: the innermost host event open at its start, else
        the next one to begin ("before ...")."""
        edges = [self.start] + [x for iv in self.busy_intervals() for x in iv] + [self.end]
        host = sorted((h for h in self.host
                       if h[0] != SLICE and not h[0].startswith("ProfilerStep")),
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        total: dict[str, float] = defaultdict(float)
        latest: list = []  # max-heap by start of the events begun so far
        taken = 0
        for gs, ge in zip(edges[0::2], edges[1::2]):
            if ge <= gs:
                continue
            while taken < len(host) and host[taken][1] <= gs:
                heapq.heappush(latest, (-host[taken][1], taken))
                taken += 1
            while latest and host[latest[0][1]][2] <= gs:  # ended: never open again
                heapq.heappop(latest)
            if latest:
                name = host[latest[0][1]][0]
            else:
                i = bisect.bisect_right(starts, gs)
                name = f"before {host[i][0]}" if i < len(host) else "host after the last launch"
            total[name[:NAME_CHARS]] += ge - gs
        return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _sentinels() -> None:
    import torch

    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _read(prof) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = Trace()
    marks = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if ev.device_type() == cuda:
            if SENTINEL in name:
                marks.append(start)
            elif not ev.is_user_annotation():
                out.device.append((name, start, end))
        elif name == SLICE:
            out.start, out.end = start, end
        else:
            out.host.append((name, start, end))
    if len(marks) >= 2:  # on a card the last two spin kernels mark the slice
        out.start, out.end = sorted(marks)[-2:]
    return out


def short_records(trace: Trace, counted: dict) -> str:
    """"" when every counted launch has its records, else what is short."""
    short = []
    for family, (_, per_launch) in KERNEL_RECORDS.items():
        got, want = trace.kernel_records(family), per_launch * counted.get(family, 0)
        if got != want:
            short.append(f"{family}: {got} records for {want} kernels counted")
    if trace.end <= trace.start:
        short.append("the slice's edges were not recorded")
    return "; ".join(short)


def traced(work, counts, device, host: bool = False, agree=None) -> Trace:
    """``work()`` under the profiler -> its ``Trace``. ``counts()`` returns
    the program's launch counters by kernel family. On a card the device
    alone is recorded, and the slice runs from a marker kernel launched just
    before the work to one launched once it has synchronized; ``host=True``
    records the host's operators too, for naming idle gaps (their recording
    slows the host). On a CPU device (the tests' rehearsal) only the host is
    recorded, and the slice is the annotation's span. Where the work holds
    collectives, ``agree`` turns this rank's shortfall into every rank's
    (``ranks.Group.agree``), so that all retry together."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = device.type == "cuda"
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])

    def sentinels():
        if cuda:
            _sentinels()

    def mark():
        if cuda:
            torch.cuda._sleep(1)

    short = ""
    for _ in range(TRIES):
        box = []
        before = counts()
        with profile(activities=activities,
                     on_trace_ready=lambda p: box.append(_read(p)),
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            sentinels()
            prof.step()
            sentinels()
            time.sleep(EDGE_S)
            sentinels()
            with record_function(SLICE):
                mark()
                work()
                if cuda:
                    torch.cuda.synchronize(device)
                mark()
            if cuda:
                torch.cuda.synchronize(device)
            time.sleep(EDGE_S)
            prof.step()
        after = counts()
        trace = box[0]
        short = short_records(trace, {k: after[k] - before[k] for k in after})
        if agree is not None:
            short = agree(short)
        if not short:
            return trace
        print(f"profiler: a session came back short: {short}", file=sys.stderr)
    raise RuntimeError(f"the profiler came back short in {TRIES} sessions: {short}")
