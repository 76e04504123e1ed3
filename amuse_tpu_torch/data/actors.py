"""BEAT actor and emotion tables and per-actor body shapes for SMPL-X export.

The port's copy of ``amuse_tpu/data/actors.py``: the 30-actor roster, the
emotion order and the two takes per emotion the released checkpoints were
trained on, the stage-1 and stage-2 actor subsets, and the vendored
300-dim MoSh betas of the 26 actors the reference ships them for
(``actor_betas.npz`` beside this module). Actors without betas upstream
(zhang, jaime, kexin, hanieh) get a zero body shape with a warning.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np

NUM_BETAS = 300
BETAS_PATH = Path(__file__).parent / "actor_betas.npz"


@dataclass(frozen=True)
class Actor:
    index: int
    name: str
    gender: str
    country: str
    native: bool
    age: int
    ethnicity: str


# BEAT v1 actor roster: 15 male / 15 female.
ACTORS: dict[int, Actor] = {
    a.index: a
    for a in [
        Actor(1, "wayne", "male", "US", True, 25, "Caucasian"),
        Actor(2, "scott", "male", "US", True, 32, "Caucasian"),
        Actor(3, "solomon", "male", "US", True, 40, "African"),
        Actor(4, "lawrence", "male", "Australia", True, 26, "Asian"),
        Actor(5, "stewart", "male", "UK", True, 30, "Caucasian"),
        Actor(6, "carla", "female", "US", True, 27, "Caucasian"),
        Actor(7, "sophie", "female", "US", True, 30, "Caucasian"),
        Actor(8, "catherine", "female", "US", True, 31, "Asian"),
        Actor(9, "miranda", "female", "UK", True, 32, "Caucasian"),
        Actor(10, "kieks", "female", "UK", True, 35, "Caucasian"),
        Actor(11, "nidal", "male", "Arab", False, 38, "African"),
        Actor(12, "zhao", "male", "Thailand", False, 32, "Asian"),
        Actor(13, "lu", "male", "China", False, 25, "Asian"),
        Actor(14, "zhang", "male", "China", False, 24, "Asian"),
        Actor(15, "carlos", "male", "China", False, 40, "Asian"),
        Actor(16, "jorge", "male", "China", False, 32, "Asian"),
        Actor(17, "itoi", "male", "Japan", False, 32, "Asian"),
        Actor(18, "daiki", "male", "Japan", False, 22, "Asian"),
        Actor(19, "jaime", "male", "Peru", False, 27, "Caucasian"),
        Actor(20, "li", "male", "Spain", False, 30, "Caucasian"),
        Actor(21, "ayana", "female", "China", False, 31, "Asian"),
        Actor(22, "luqi", "female", "China", False, 24, "Asian"),
        Actor(23, "hailing", "female", "China", False, 26, "Asian"),
        Actor(24, "kexin", "female", "China", False, 32, "Asian"),
        Actor(25, "goto", "female", "Japan", False, 24, "Asian"),
        Actor(26, "reamey", "female", "Japan", False, 26, "Asian"),
        Actor(27, "yingqing", "female", "Iran", False, 31, "African"),
        Actor(28, "tiffnay", "female", "Jamaica", False, 33, "African"),
        Actor(29, "hanieh", "female", "Jamaica", False, 24, "Asian"),
        Actor(30, "katya", "female", "Russia", False, 25, "Caucasian"),
    ]
}

NAME_TO_GENDER: dict[str, str] = {a.name: a.gender for a in ACTORS.values()}

# Stage-2 training subset: every actor but the 5 with missing or incorrect
# MoSh data.
EXCLUDED_STAGE2_ACTORS = (11, 20, 24, 25, 27)
STAGE2_ACTOR_IDS = tuple(i for i in range(1, 31) if i not in EXCLUDED_STAGE2_ACTORS)

# Stage-1 split: 3 validation actors; 2 dropped for incorrect emotion labels.
STAGE1_VAL_ACTORS = ("nidal", "li", "kexin")
STAGE1_DROPPED_ACTORS = ("yingqing", "goto")

# Emotion id order, and the two takes per emotion of the released checkpoints.
EMOTIONS = (
    "neutral", "happy", "angry", "sad", "contempt", "surprise", "fear", "disgust"
)
PRETRAINED_TAKES: dict[str, tuple[str, str]] = {
    "neutral": ("0_9_9", "0_10_10"),
    "happy": ("0_65_65", "0_66_66"),
    "angry": ("0_73_73", "0_74_74"),
    "sad": ("0_81_81", "0_82_82"),
    "contempt": ("0_87_87", "0_88_88"),
    "surprise": ("0_95_95", "0_96_96"),
    "fear": ("0_103_103", "0_104_104"),
    "disgust": ("0_111_111", "0_112_112"),
}
PRETRAINED_TAKE_NUMBERS = tuple(
    t.split("_")[-1] for pair in PRETRAINED_TAKES.values() for t in pair
)


def emotion_id(name: str) -> int:
    return EMOTIONS.index(name)


def takes_for_emotion(emotion: str) -> tuple[str, str]:
    return PRETRAINED_TAKES[emotion]


@functools.lru_cache(maxsize=1)
def _load_betas() -> dict[str, np.ndarray]:
    with np.load(BETAS_PATH, allow_pickle=False) as d:
        return {k: np.asarray(d[k], np.float64) for k in d.files}


def subject_to_gender_beta(subject: str) -> tuple[str, np.ndarray]:
    """actor name -> (gender, (300,) betas); unknown actors are 'neutral'."""
    gender = NAME_TO_GENDER.get(subject, "neutral")
    betas = _load_betas().get(subject)
    if betas is None:
        warnings.warn(
            f"no MoSh betas for actor {subject!r}; using a zero body shape",
            stacklevel=2,
        )
        return gender, np.zeros(NUM_BETAS, np.float64)
    return gender, betas.copy()


def betas_for_batch(subjects: list[str]) -> np.ndarray:
    """Stacked (N, 300) betas for a batch of actor names."""
    return np.stack([subject_to_gender_beta(s)[1] for s in subjects])
