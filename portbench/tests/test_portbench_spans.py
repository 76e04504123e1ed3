"""The program's spans read against a device trace (``portbench/spans.py``):
``LinkedTrace.by_span``, ``LinkedTrace.idle_by_span`` and the span readers
on traces set by hand; each cell's span pass rehearsed on the CPU at tiny
widths; and on a CUDA card the one clock that spans, runtime calls and
device operations share (marked ``gpu``)."""

from __future__ import annotations

import importlib
import time
from collections import Counter

import pytest
import torch

from amuse_tpu_torch.utils.profiling import Span, recording, span
from portbench import spans as spanning
from portbench import trace as tracing
from portbench.tests import tiny

MS = 1_000_000  # ns


def _spans() -> list[Span]:
    """Two requests, as a recorder lists them (in the order they began):
    req [1, 100) holding a [10, 40) and b [50, 90), b holding b1 [60, 70);
    req [200, 260) holding a [210, 250). Times in ms."""
    rows = [("req", 1, 100, -1, 0), ("a", 10, 40, 0, 0), ("b", 50, 90, 0, 0),
            ("b1", 60, 70, 2, 0), ("req", 200, 260, -1, 1), ("a", 210, 250, 4, 1)]
    return [Span(n, s * MS, e * MS, p, r) for n, s, e, p, r in rows]


# (launch ms or None for no linked call, device start ms, device end ms, owner)
OPS = [(5, 12, 15, "req"),  # launched in req, outside its children
       (20, 20, 30, "a"),
       (55, 56, 58, "b"),  # launched in b, not in its child b1
       (65, 66, 68, "b1"),
       (None, 95, 96, spanning.UNLINKED),
       (150, 150, 160, spanning.OUTSIDE),  # between the requests: the harness's own
       (215, 216, 230, "a"),
       (255, 310, 320, None)]  # runs after the slice ends


def _trace() -> spanning.LinkedTrace:
    t = spanning.LinkedTrace(start=0.0, end=0.300)
    for i, (launch, s, e, _) in enumerate(OPS):
        t.device.append((f"op{i}", s * 1e-3, e * 1e-3))
        t.links.append(100 + i)
        if launch is not None:
            t.launched_ns[100 + i] = launch * MS
    return t


def _got(spans, trace, requests=2) -> spanning.SpanTrace:
    return spanning.SpanTrace(spans, trace, requests)


def test_each_operation_goes_to_the_innermost_span_open_at_its_launch():
    by = _trace().by_span(_spans())
    want = {}
    for _, s, e, owner in OPS[:-1]:
        want[owner] = want.get(owner, 0.0) + (e - s) * 1e-3
    assert by.keys() == want.keys()
    for k in want:
        assert by[k] == pytest.approx(want[k], rel=1e-9), k


def test_the_parts_sum_to_the_slices_device_time():
    trace = _trace()
    total = sum((e - s) * 1e-3 for _, s, e, _ in OPS[:-1])
    assert sum(d for _, d in trace.slice_ops()) == pytest.approx(total, rel=1e-12)
    assert sum(trace.by_span(_spans()).values()) == pytest.approx(total, rel=1e-12)


def test_each_gap_goes_to_the_span_open_when_it_opened():
    """Gaps of the busy union inside the slice: [0, 12) opens before any
    span, [15, 20) and [30, 56) in a, [58, 66) in b, [68, 95) in b1,
    [96, 150) in req, [160, 216) between the requests, [230, 300) in the
    second request's a."""
    idle = _trace().idle_by_span(_spans())
    want = {spanning.OUTSIDE: 12 + 56, "a": 5 + 26 + 70, "b": 8, "b1": 27, "req": 54}
    assert idle.keys() == want.keys()
    for k, ms in want.items():
        assert idle[k] == pytest.approx(ms * 1e-3, rel=1e-9), k


def test_the_readers_count_nested_spans_in_their_ancestors():
    """Per request (two): b holds b1's operations and gaps; req holds every
    operation launched in a request; several names are summed once."""
    got = _got(_spans(), _trace())
    assert spanning.device_ms(got, "b") == pytest.approx((2 + 2) / 2)
    assert spanning.device_ms(got, "b1") == pytest.approx(2 / 2)
    assert spanning.device_ms(got, "req") == pytest.approx((3 + 10 + 2 + 2 + 14) / 2)
    assert spanning.device_ms(got, "req", "a", "b") == pytest.approx((3 + 10 + 2 + 2 + 14) / 2)
    assert spanning.idle_ms(got, "b") == pytest.approx((8 + 27) / 2)
    assert spanning.idle_ms(got, "a", "b1") == pytest.approx((101 + 27) / 2)
    assert spanning.launches(got, "req") == pytest.approx(5 / 2)
    assert spanning.launches(got, "a") == pytest.approx(2 / 2)


def test_the_spans_line_partitions_the_slice():
    table = spanning.table(_got(_spans(), _trace()))
    rows = table["per_request"]
    assert set(rows) == {"req", "a", "b", "b1", spanning.OUTSIDE, spanning.UNLINKED}
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(table["device_ms"])
    assert table["device_ms"] == pytest.approx((3 + 10 + 2 + 2 + 1 + 10 + 14) / 2)
    assert table["in_spans_pct"] == pytest.approx(100 * 31 / 42)
    assert sum(r["launches"] for r in rows.values()) == pytest.approx(7 / 2)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx((300 - 42) / 2)


def test_nothing_to_read_gives_none():
    """No span pass (a program without spans) or no device operation (a
    CPU run): the readers return None, and no metric has a value."""
    on_cpu = _got(_spans(), spanning.LinkedTrace(start=0.0, end=0.3))
    for got in (None, on_cpu):
        assert spanning.device_ms(got, "a") is None
        assert spanning.idle_ms(got, "a") is None
        assert spanning.launches(got, "req") is None
        for cell in ("infer.b32", "infer.clips", "stage1.q8"):
            assert spanning.metrics(got, cell) == {}


def test_each_metric_reads_spans_its_cell_opens():
    for name, (cell, how, names) in spanning.METRICS.items():
        assert how in ("device_ms", "idle_ms", "launches"), name
        assert set(names) <= SPANS[cell], name
        assert name.endswith("." + cell.split(".")[1]), name


INFER_SPANS = {"infer.request", "infer.upload", "infer.fbank", "infer.ast", "infer.sampler",
               "infer.decode"}
SPANS = {"infer.b32": INFER_SPANS, "infer.clips": INFER_SPANS | {"infer.download"},
         "stage1.q8": {"train.upload", "train.step", "train.augment", "train.encode",
                       "train.reconstruct", "train.loss", "train.backward", "train.optimizer"}}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_cells_span_pass_returns_the_spans_its_entry_opens(name):
    """The span pass over a cell's slice at tiny widths on the CPU: every
    request opens the spans of its entry once each, and no other span."""
    cell = tiny.cell(name)
    system = importlib.import_module(f"portbench.systems.{cell.config['system']}")
    device = torch.device("cpu")
    sut = system.Session(cell.config, cell.traffic, cell.settings, 2**31 + 77, device)
    requests = [sut.traffic.request(100 + i) for i in range(2)]
    t = time.perf_counter()
    got = spanning.cell_pass(sut, requests, device)
    sut.release()
    assert got.requests == 2 and time.perf_counter() - t < 120
    assert Counter(sp.name for sp in got.spans) == dict.fromkeys(SPANS[name], 2)
    roots = [sp for sp in got.spans if sp.parent < 0]
    assert len({sp.request for sp in got.spans}) == len(roots)
    # an inference request is one root; the harness uploads a step's quads before the step
    assert len(roots) == (4 if name == "stage1.q8" else 2)
    table = spanning.table(got)
    assert set(table["per_request"]) == SPANS[name] | {spanning.OUTSIDE}


# ------------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the clock is that of CUPTI's records")
    return torch.device("cuda", 0)


def _counts() -> dict:
    from amuse_tpu_torch.ops import attention, denoiser_kernel

    return {"attention_fwd": attention.mha.launches,
            "attention_bwd": attention.mha_bwd.launches,
            "ddim_sampler": denoiser_kernel.ddim_sample_fused.launches}


def _owners_of(got: spanning.SpanTrace, family: str) -> list:
    owners = got.trace.launch_owners(got.spans)
    return [owners[i] for i, (name, _, _) in enumerate(got.trace.device)
            if tracing.kernel_family(name) == family]


@pytest.mark.gpu
def test_a_launch_lies_inside_its_span_on_the_profilers_clock(cuda):
    """A device-only session: the runtime call of a kernel launched inside
    a span lies inside the span, and the kernel starts after the span began."""
    from torch.profiler import ProfilerActivity, profile, schedule

    box = []
    with profile(activities=[ProfilerActivity.CUDA],
                 on_trace_ready=lambda p: box.append(list(p.profiler.kineto_results.events())),
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(1000)  # the warm-up step takes the records CUPTI may drop
        torch.cuda.synchronize()
        prof.step()
        with recording() as rec:
            for _ in range(5):
                with span("probe"):
                    torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        prof.step()
    events = box[0]
    on_card = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type() == on_card and tracing.SENTINEL in e.name()]
    calls = {e.correlation_id(): e for e in events
             if e.device_type() != on_card and e.name().startswith("cuda")}
    assert len(kernels) == 5 and len(rec.spans) == 5
    for k, sp in zip(sorted(kernels, key=lambda e: e.start_ns()), rec.spans):
        call = calls[k.correlation_id()]
        after, before = call.start_ns() - sp.start_ns, sp.end_ns - call.end_ns()
        print(f"clock: {call.name()} begins {after} ns after its span opened and ends "
              f"{before} ns before it closed; the kernel starts {k.start_ns() - sp.start_ns} ns "
              "after the span opened")
        assert after >= 0 and before >= 0 and k.start_ns() >= sp.start_ns


@pytest.mark.gpu
def test_k1_and_k3_launch_in_their_spans(cuda):
    """One wav_to_motion of four windows at the published widths: all 12 K1
    records in infer.ast, the K3 record in infer.sampler."""
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params

    pipe = GesturePipeline(init_random_params(0), device=cuda)
    chunks = torch.randn(4, 160_000, generator=torch.Generator().manual_seed(0)).numpy() * 0.1
    pipe.wav_to_motion(chunks)  # builds and loads the kernels
    got = spanning.traced_spans(lambda: pipe.wav_to_motion(chunks), _counts, cuda)
    k1, k3 = _owners_of(got, "attention_fwd"), _owners_of(got, "ddim_sampler")
    assert len(k1) == 12 and all(spanning.within(got.spans, o, ("infer.ast",)) for o in k1)
    assert len(k3) == 1 and spanning.within(got.spans, k3[0], ("infer.sampler",))
    table = spanning.table(got)
    print("spans:", table)
    assert table["in_spans_pct"] >= 95.0


@pytest.mark.gpu
def test_k2_launches_in_the_backward_span(cuda):
    """One train step of one quad at the published widths: all 12 K2
    launches (36 records) in train.backward, the 12 K1 in train.encode."""
    import numpy as np

    from amuse_tpu_torch.train import audio as ta

    state = ta.init_state(0, device=cuda)
    step, _ = ta.make_train_step()
    rng = np.random.default_rng(0)
    batch = {"fbanks": rng.normal(size=(1, 4, 1024, 128)).astype(np.float32),
             "emo_id": np.array([1]), "a1_id": np.array([2]), "a2_id": np.array([3])}

    def one_step():
        step(state, ta.batch_to_device(batch, cuda), torch.Generator(device=cuda).manual_seed(1))

    one_step()
    got = spanning.traced_spans(one_step, _counts, cuda)
    k2, k1 = _owners_of(got, "attention_bwd"), _owners_of(got, "attention_fwd")
    assert len(k2) == 36 and all(spanning.within(got.spans, o, ("train.backward",)) for o in k2)
    assert len(k1) == 12 and all(spanning.within(got.spans, o, ("train.encode",)) for o in k1)
    table = spanning.table(got)
    print("spans:", table)
    assert table["in_spans_pct"] >= 95.0
