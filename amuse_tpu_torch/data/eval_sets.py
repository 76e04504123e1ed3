"""Editing-task evaluation sets.

Port of ``amuse_tpu/data/eval_sets.py``: select the actor/take
combinations each editing task needs and load their waveform and motion,
the inputs of ``infer.editing.encode_take``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

from amuse_tpu_torch.audio.wavio import load_wav_resampled
from amuse_tpu_torch.data import beat as beat_mod
from amuse_tpu_torch.data.actors import PRETRAINED_TAKES, takes_for_emotion


@dataclass(frozen=True)
class EvalItem:
    actor: str
    take: str
    emotion: str
    waveform: np.ndarray  # (C, N) float32 at 16 kHz
    motion: Optional[np.ndarray]  # (T, 168) or None


def _load_item(take: beat_mod.Take, emotion: str) -> EvalItem:
    wave = load_wav_resampled(take.wav)
    motion = beat_mod.load_mosh_motion(take.mosh_npz) if take.mosh_npz else None
    return EvalItem(take.actor_name, take.take, emotion, wave, motion)


def _find(takes: list[beat_mod.Take], actor: str, take: str) -> Optional[beat_mod.Take]:
    return next((t for t in takes if t.actor_name == actor and t.take == take), None)


def emotion_control_set(takes: list[beat_mod.Take], actor: str,
                        emotions: Optional[list[str]] = None) -> list[EvalItem]:
    """One actor, the first take of each requested emotion. An emotion whose
    take is absent from the tree is skipped with a warning."""
    items = []
    for emo in emotions or list(PRETRAINED_TAKES):
        take = takes_for_emotion(emo)[0]
        t = _find(takes, actor, take)
        if t is not None:
            items.append(_load_item(t, emo))
        else:
            warnings.warn(f"emotion_control_set: take {take} ({emo}) missing for actor "
                          f"{actor}; emotion skipped", stacklevel=2)
    return items


def style_transfer_set(takes: list[beat_mod.Take], actor1: str, actor2: str,
                       emotion: str) -> tuple[list[EvalItem], list[EvalItem]]:
    """Two actors x the two takes of one emotion. An actor with fewer than
    both takes contributes what exists (warned); ``style_transfer`` pairs the
    shorter list's length."""
    t1, t2 = takes_for_emotion(emotion)
    found = []
    for actor in (actor1, actor2):
        items = [_load_item(t, emotion) for t in (_find(takes, actor, x) for x in (t1, t2))
                 if t is not None]
        if len(items) < 2:
            warnings.warn(f"style_transfer_set: actor {actor} has {len(items)}/2 {emotion} "
                          f"takes ({t1}, {t2}) in the tree", stacklevel=2)
        found.append(items)
    return found[0], found[1]


def style_xemo_set(takes: list[beat_mod.Take], actor1: str, actor2: str, emotion1: str,
                   emotion2: str, rng: Optional[np.random.Generator] = None,
                   ) -> dict[str, EvalItem]:
    """Two actors x two emotions -> the corners a1_e1, a1_e2, a2_e1, a2_e2.

    ``rng`` draws which of an emotion's two takes represents it (once per
    emotion, shared by both actors), as the reference redraws per
    replication; without it the first take is used. A missing corner raises
    ``FileNotFoundError``.
    """
    if rng is None:
        t_e1, t_e2 = takes_for_emotion(emotion1)[0], takes_for_emotion(emotion2)[0]
    else:
        t_e1 = takes_for_emotion(emotion1)[int(rng.integers(2))]
        t_e2 = takes_for_emotion(emotion2)[int(rng.integers(2))]
    out = {}
    for key, actor, take, emo in (("a1_e1", actor1, t_e1, emotion1),
                                  ("a1_e2", actor1, t_e2, emotion2),
                                  ("a2_e1", actor2, t_e1, emotion1),
                                  ("a2_e2", actor2, t_e2, emotion2)):
        t = _find(takes, actor, take)
        if t is None:
            raise FileNotFoundError(f"take {take} for actor {actor} not found")
        out[key] = _load_item(t, emo)
    return out
