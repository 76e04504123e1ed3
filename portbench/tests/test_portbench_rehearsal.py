"""Each cell's run rehearsed on the CPU at tiny widths: the traffic, the
window, the traced slice and the check as a run drives them, and the
contract's last line. Then the same run with the timed path broken
underneath, in each way that the cell can be broken: ``correct`` must come
out false. These are the one-card cells; ``stage1.dp4`` runs across cards,
and ``test_portbench_ranks.py`` rehearses it as two ranks, the exchange
between them left out among its faults."""

from __future__ import annotations

import json
import time

import pytest
import torch

from amuse_tpu_torch.infer import pipeline as pipeline_mod
from amuse_tpu_torch.train import audio as train_audio
from portbench.run import result_line, run_cell
from portbench.tests import tiny

CPU = torch.device("cpu")
CELLS = ("infer.b32", "infer.clips", "stage1.q8")
SEED = 2**31 + 12_345  # the driver's seeds are this large


def _run(name: str, trace: bool, seconds: float = 1.0) -> dict:
    cell = tiny.cell(name)
    return run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_a_run_prints_the_contracts_line(name, trace):
    cell = tiny.cell(name)
    result = _run(name, trace)
    line = json.loads(result_line(result, {"platform": "cpu", "kind": "cpu", "count": 1}))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["compared"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        if m["source"] == "device_trace" and "idle" not in m["name"]:
            continue  # a kernel's share or time: no kernel runs on the CPU, so it is left out
        assert line["metrics"][m["name"]]["unit"] == m["unit"], m["name"]
        assert line["metrics"][m["name"]]["value"] > 0 or "idle" in m["name"]
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) <= 10


def _unchanged(denoiser, schedule, con, emo=None, sty=None, num_steps=50,
               initial_latents=None, generator=None, **_):
    """The sampler handing back the state it started from."""
    shape = (con.shape[0], denoiser.cfg.latent_tokens, denoiser.cfg.latent_dim)
    if initial_latents is not None:
        return initial_latents.to(con.device, torch.float32)
    return torch.randn(shape, generator=generator, device=con.device, dtype=torch.float32)


def _half_batch(real):
    """wav_to_motion on the first half of the windows; the rest given the mean of those."""
    def broken(self, chunks, generator=None, initial_latents=None):
        n = len(chunks)
        keep = (n + 1) // 2
        poses, trans = real(self, chunks[:keep], generator,
                            None if initial_latents is None else initial_latents[:keep])
        fill = n - keep
        return (torch.cat([poses, poses.mean(0, keepdim=True).expand(fill, -1, -1, -1)]),
                torch.cat([trans, trans.mean(0, keepdim=True).expand(fill, -1, -1)]))
    return broken


def _altered(real):
    """wav_to_motion with one window's answer replaced where it is produced:
    the last window gets the first one's motion (a clip of one window, its
    motion mirrored)."""
    def broken(self, chunks, generator=None, initial_latents=None):
        poses, trans = real(self, chunks, generator, initial_latents)
        poses, trans = poses.clone(), trans.clone()
        if len(chunks) > 1:
            poses[-1], trans[-1] = poses[0], trans[0]
        else:
            poses[0], trans[0] = -poses[0], -trans[0]
        return poses, trans
    return broken


def _half_loss(real):
    """The stage-1 loss over the first half of the batch's quads alone."""
    def broken(model, batch, cfg, generator=None, augment=True, grad_sync=None):
        keep = max(1, batch["fbanks"].shape[0] // 2)
        return real(model, {k: v[:keep] for k, v in batch.items()}, cfg, generator, augment,
                    grad_sync)
    return broken


INFER_FAULTS = {
    "sampler_returns_its_state": lambda mp: mp.setattr(pipeline_mod, "ddim_sample_fused",
                                                       _unchanged),
    "half_the_batch_left_out": lambda mp: mp.setattr(
        pipeline_mod.GesturePipeline, "wav_to_motion",
        _half_batch(pipeline_mod.GesturePipeline.wav_to_motion)),
    "an_answer_altered": lambda mp: mp.setattr(
        pipeline_mod.GesturePipeline, "wav_to_motion",
        _altered(pipeline_mod.GesturePipeline.wav_to_motion)),
}
TRAIN_FAULTS = {
    "step_returns_its_state": lambda mp: mp.setattr(torch.optim.Adam, "step",
                                                    lambda self, closure=None: None),
    "half_the_batch_left_out": lambda mp: mp.setattr(train_audio, "loss_fn",
                                                     _half_loss(train_audio.loss_fn)),
}
BROKEN = ([(name, f) for name in CELLS[:2] for f in sorted(INFER_FAULTS)]
          + [("stage1.q8", f) for f in sorted(TRAIN_FAULTS)])


@pytest.mark.parametrize("name,fault", BROKEN)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    (TRAIN_FAULTS if name == "stage1.q8" else INFER_FAULTS)[fault](monkeypatch)
    result = _run(name, trace=False)
    assert result["correct"] is False, result["compared"]
