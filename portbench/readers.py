"""Arithmetic that the metric readers (``metrics/<name>.py``) share. Each
takes the run's ``Context`` and returns a number, or None where the run
gave nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import statistics

from portbench import roofline


def _elapsed(ctx) -> float:
    return ctx.window.end - ctx.window.start


def samples_per_s(ctx):
    """Samples (the config's: 10 s windows turned into motion, quads trained)
    over all the work and all the time of the window."""
    return sum(d.request.samples for d in ctx.window.done) / _elapsed(ctx)


def latency_p95_ms(ctx):
    """The 95th percentile over all requests of the window, call to return."""
    lat = [(d.end - d.start) * 1e3 for d in ctx.window.done]
    if len(lat) == 1:
        return lat[0]
    return statistics.quantiles(lat, n=100, method="inclusive")[94]


def setup_s(ctx):
    return ctx.setup_s


def infer_mfu_pct(ctx):
    """Model FLOPs of the windows served in the window over its length at
    the bf16 peak (989 TFLOP/s)."""
    windows = sum(d.request.samples for d in ctx.window.done)
    flops = windows * roofline.infer_window_flops(ctx.cfg)
    return 100.0 * flops / (_elapsed(ctx) * roofline.PEAK_BF16_FLOPS)


def train_mfu_pct(ctx):
    """Model FLOPs of the steps in the window (forward plus twice it for the
    backward, from shapes; a step's samples are its global batch) over its
    length at the bf16 peak of the cell's cards."""
    flops = sum(roofline.stage1_step_flops(ctx.cfg, d.request.samples) for d in ctx.window.done)
    return 100.0 * flops / (_elapsed(ctx) * roofline.PEAK_BF16_FLOPS * ctx.chips)


def kernels_ms_per_request(ctx, mark: str):
    """Device ms a request of the traced slice of the kernels whose names hold ``mark``."""
    if ctx.trace is None or not ctx.slice_requests:
        return None
    seconds = sum(e - s for name, s, e in ctx.trace.device if mark in name)
    return 1e3 * seconds / len(ctx.slice_requests) if seconds > 0 else None


def kernel_roofline_pct(ctx, family: str, dtype: str):
    """The kernel's least time (its work in the traced slice over the peak
    of its type or of HBM) as a share of its device time in the trace."""
    if ctx.trace is None or ctx.counted.get(family, 0) == 0:
        return None
    seconds = ctx.trace.kernel_seconds(family)
    if seconds <= 0:
        return None
    flops, nbytes = ctx.slice_work[family]
    return roofline.roofline_pct(flops, nbytes, seconds, dtype)


def device_idle_pct(ctx):
    """The share of the slice's requests run untraced (host clock) that the
    union of device operations, traced over the same requests with the
    device alone recorded, does not cover. The traced slice itself is
    longer by the profiler's cost on the host (``device.window_s``), which
    would read as device idle where the host paces the work."""
    if ctx.trace is None or ctx.slice_untraced_s <= 0:
        return None
    return 100.0 * (ctx.slice_untraced_s - ctx.trace.busy_s) / ctx.slice_untraced_s
