"""Gesture editing: latent recombination across actors, takes and emotions.

Port of ``amuse_tpu/infer/editing.py`` (the reference's
``PretrainedLPDM_v1.process_loader`` tasks):

  * emotion_control      - one actor; each take regenerated under the
    emotion latent of every other take (same content and style).
  * style_transfer       - two actors, one emotion; latents exchanged
    between partners. ``reference_quirk=True`` keeps the reference's
    crosswise assignment (the partner's *emotion* feature in the style slot
    and vice versa); False swaps them straight.
  * style_xemo_transfer  - two actors x two emotions; emotion and style
    swapped straight across the diagonal.
  * content_control      - the content latent swapped across takes.
  * demo_emotion_swap    - source audio with a target audio's emotion.

Every encode is one ``GesturePipeline.encode_audio`` over a take's windows
(12 launches of the attention kernel K1 on the card); every variant is one
``generate_with`` call, one launch of the sampler kernel K3 at N = the
source's windows. ``generate_with`` seeds a generator of its own with
``seed`` on every call, so "self" and all variants of a source start from
the same initial latents and differ only by their conditioning. Latents
stay on the pipeline's device; generated motion comes back as numpy.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from amuse_tpu_torch.audio import fbank as fbank_mod
from amuse_tpu_torch.core import motion as motion_mod
from amuse_tpu_torch.infer.pipeline import GesturePipeline


@dataclass
class TakeLatents:
    """Per-take encoded state: (n_windows, feature_dim) features on the
    pipeline's device, and the motion latents when motion was given."""

    actor: str
    take: str
    emo_label: int
    con: torch.Tensor
    emo: torch.Tensor
    sty: torch.Tensor
    z_motion: Optional[torch.Tensor] = None  # (n_windows, 1, latent_dim)


def _generator(pipe: GesturePipeline, seed: int) -> torch.Generator:
    return torch.Generator(device=pipe.device).manual_seed(seed)


def encode_take(
    pipe: GesturePipeline,
    actor: str,
    take: str,
    emo_label: int,
    waveform: np.ndarray,
    motion_aa: Optional[np.ndarray] = None,  # (T, 168) raw axis-angle + trans
    seed: int = 0,
) -> TakeLatents:
    """Audio (and motion, when given) -> latents. With motion, the windows
    are cut to the shorter of the two and the motion latents are sampled
    with noise from a generator seeded with ``seed``."""
    chunks = fbank_mod.window_waveform(waveform)
    cond = pipe.encode_audio(chunks)
    con, emo, sty = cond["con"], cond["emo"], cond["sty"]
    z_motion = None
    if motion_aa is not None:
        motion = torch.as_tensor(np.asarray(motion_aa, np.float32)).to(pipe.device)
        windows = motion_mod.window_motion(motion)
        feats = pipe.motion_feats(windows)  # the rep the prior was trained on
        n = min(len(chunks), feats.shape[0])
        z_motion = pipe.encode_motion(feats[:n], _generator(pipe, seed))
        con, emo, sty = con[:n], emo[:n], sty[:n]
    return TakeLatents(actor, take, emo_label, con, emo, sty, z_motion)


def generate_with(pipe: GesturePipeline, con, emo, sty,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Conditioning -> (poses (N, 300, 55, 3), trans (N, 300, 3)) as numpy:
    one sampler launch, initial latents from a generator seeded with ``seed``."""
    on = [torch.as_tensor(x).to(pipe.device) for x in (con, emo, sty)]
    latents = pipe.generate_latents(*on, generator=_generator(pipe, seed))
    poses, trans = pipe.decode_motion(latents)
    return poses.cpu().numpy(), trans.cpu().numpy()


# ------------------------------------------------------------------ tasks


def emotion_control(pipe: GesturePipeline, takes: list[TakeLatents],
                    seed: int = 0) -> dict[str, dict]:
    """For each take: its own generation and one under every other take's
    emotion latent."""
    out: dict[str, dict] = {}
    for tk in takes:
        n = min(len(tk.con), *(len(o.emo) for o in takes))
        results = {"self": generate_with(pipe, tk.con[:n], tk.emo[:n], tk.sty[:n], seed)}
        for other in takes:
            if other.take == tk.take:
                continue
            results[f"emo_{other.take}"] = generate_with(
                pipe, tk.con[:n], other.emo[:n], tk.sty[:n], seed)
        out[f"{tk.actor}_{tk.take}"] = results
    return out


def style_transfer(pipe: GesturePipeline, a1_takes: list[TakeLatents],
                   a2_takes: list[TakeLatents], seed: int = 0,
                   reference_quirk: bool = True) -> dict[str, dict]:
    """Two actors, one emotion: exchange style (and emotion) latents between
    partners; the takes pair up to the shorter list's length (warned)."""
    if len(a1_takes) != len(a2_takes):
        n_pairs = min(len(a1_takes), len(a2_takes))
        warnings.warn(
            f"style_transfer: actors have {len(a1_takes)} vs {len(a2_takes)} takes; only "
            f"the first {n_pairs} of each are paired - the remaining takes produce no output",
            stacklevel=2,
        )
    out: dict[str, dict] = {}
    for tk, partner in list(zip(a1_takes, a2_takes)) + list(zip(a2_takes, a1_takes)):
        n = min(len(tk.con), len(partner.con))
        if reference_quirk:  # the partner's emotion feature lands in the style slot
            swapped_sty, swapped_emo = partner.emo[:n], partner.sty[:n]
        else:
            swapped_sty, swapped_emo = partner.sty[:n], partner.emo[:n]
        out[f"{tk.actor}_{tk.take}"] = {
            "self": generate_with(pipe, tk.con[:n], tk.emo[:n], tk.sty[:n], seed),
            f"sty_{partner.actor}": generate_with(pipe, tk.con[:n], swapped_emo,
                                                  swapped_sty, seed),
        }
    return out


def style_xemo_transfer(pipe: GesturePipeline, a1_t1: TakeLatents, a1_t2: TakeLatents,
                        a2_t1: TakeLatents, a2_t2: TakeLatents,
                        seed: int = 0) -> dict[str, dict]:
    """Two actors x two emotions: a straight swap of emotion and style
    latents across the diagonal (a1_t1 takes a2_t2's, and so on)."""
    out: dict[str, dict] = {}
    for tk, donor in ((a1_t1, a2_t2), (a2_t1, a1_t2), (a1_t2, a2_t1), (a2_t2, a1_t1)):
        n = min(len(tk.con), len(donor.con))
        out[f"{tk.actor}_{tk.take}"] = {
            "self": generate_with(pipe, tk.con[:n], tk.emo[:n], tk.sty[:n], seed),
            f"xfer_{donor.actor}_{donor.take}": generate_with(
                pipe, tk.con[:n], donor.emo[:n], donor.sty[:n], seed),
        }
    return out


def content_control(pipe: GesturePipeline, takes: list[TakeLatents],
                    seed: int = 0) -> dict[str, dict]:
    """Swap the content latent across takes, keeping emotion and style (the
    reference declares this task but never implements it)."""
    out: dict[str, dict] = {}
    for tk in takes:
        n = min(len(tk.con), *(len(o.con) for o in takes))
        results = {"self": generate_with(pipe, tk.con[:n], tk.emo[:n], tk.sty[:n], seed)}
        for other in takes:
            if other.take == tk.take:
                continue
            results[f"con_{other.take}"] = generate_with(
                pipe, other.con[:n], tk.emo[:n], tk.sty[:n], seed)
        out[f"{tk.actor}_{tk.take}"] = results
    return out


def demo_emotion_swap(pipe: GesturePipeline, source_wave: np.ndarray,
                      target_wave: np.ndarray, seed: int = 0) -> dict[str, tuple]:
    """The shipped demo: the source audio generated with its own content and
    style, and again with the target audio's emotion."""
    src = pipe.encode_audio(fbank_mod.window_waveform(source_wave))
    tgt = pipe.encode_audio(fbank_mod.window_waveform(target_wave))
    n = min(src["con"].shape[0], tgt["emo"].shape[0])
    return {
        "original": generate_with(pipe, src["con"][:n], src["emo"][:n], src["sty"][:n], seed),
        "emotion_swapped": generate_with(pipe, src["con"][:n], tgt["emo"][:n],
                                         src["sty"][:n], seed),
    }
