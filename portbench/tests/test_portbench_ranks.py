"""The run of a cell on several cards rehearsed on the CPU: ``stage1.dp4``
at tiny widths (``tiny.py``) as two ranks over gloo, started by the
harness's launcher (``ranks.launch``), each running
``rank_rehearsal.py``. Rank 0 alone prints the contract's line and every
rank runs the same requests; with the timed path broken underneath in each
way that a data-parallel step can be broken, ``correct`` comes out false;
a rank that raises ends every rank."""

from __future__ import annotations

import json
import time

import pytest

from portbench import ranks
from portbench.tests.tiny import ROOT

SCRIPT = str(ROOT / "portbench" / "tests" / "rank_rehearsal.py")
SEED = 2**31 + 54_321  # a seed beyond 32 signed bits, as runs are given
WORLD = 2
TIMEOUT_S = 240.0
ENV = {"OMP_NUM_THREADS": "2"}  # two ranks that share the CPU's cores


def _launch(*extra: str, trace: int = 0) -> ranks.Launched:
    import os

    argv = [SCRIPT, "--seed", str(SEED), "--seconds", "1.0", "--trace", str(trace),
            "--launched-at", repr(time.perf_counter()), *extra]
    return ranks.launch(argv, WORLD, TIMEOUT_S, env={**os.environ, **ENV})


def _line(out: ranks.Launched) -> dict:
    assert out.rc == 0, "\n".join(out.stderr[out.failed_rank or 0][-30:])
    assert all(not lines for lines in out.stdout[1:]), out.stdout[1:]
    lines = [x for x in out.stdout[0] if x.startswith("{")]
    assert len(lines) == 1 and out.stdout[0][-1] == lines[0], out.stdout[0]
    return json.loads(lines[0])


@pytest.mark.parametrize("trace", [0, 1], ids=["trace0", "trace1"])
def test_rank_0_prints_one_line_and_every_rank_runs_the_same_requests(trace):
    out = _launch(trace=trace)
    line = _line(out)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["compared"]
    assert line["correct"] is True, line["compared"]
    assert line["device"] == {**line["device"], "platform": "cpu", "count": WORLD}
    assert line["compared"]["replicas_apart"]["value"] == 0
    requests = next(x for x in out.stderr[0] if x.startswith("rank_requests ")).split()[1:]
    assert requests == [str(line["attempted"])] * WORLD
    if trace:
        assert set(line["metrics"]) == {"device_idle_pct.dp4", "train_mfu_pct.dp4"}
        assert line["device"]["window_s"] > 0  # no device operation runs on the CPU
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
        stages = next(x for x in out.stderr[0] if x.startswith("stages ")).split()[1::2]
        assert stages[:4] == ["spawn_s", "imports_s", "join_s", "first_collective_s"]


@pytest.mark.parametrize("fault", ["exchange", "unchanged", "half"])
def test_a_broken_data_parallel_step_is_not_correct(fault):
    line = _line(_launch("--fault", fault))
    assert line["correct"] is False, line["compared"]


def test_a_failing_rank_ends_every_rank():
    t0 = time.monotonic()
    out = _launch("--fail-rank", "1")
    assert out.rc not in (0, 124) and out.failed_rank is not None
    assert not any(x.startswith("{") for x in out.stdout[0])
    assert any("a planted failure" in x for x in out.stderr[1])
    assert time.monotonic() - t0 < TIMEOUT_S / 2
