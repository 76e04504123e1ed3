"""BEAT actor metadata and per-actor body shapes for SMPL-X export.

The port's copy of the parts of ``amuse_tpu/data/actors.py`` that the
export needs: the 30-actor roster (name -> gender) and the vendored
300-dim MoSh betas of the 26 actors the reference ships them for
(``actor_betas.npz`` beside this module). Actors without betas upstream
(zhang, jaime, kexin, hanieh) get a zero body shape with a warning.
"""

from __future__ import annotations

import functools
import warnings
from pathlib import Path

import numpy as np

NUM_BETAS = 300
BETAS_PATH = Path(__file__).parent / "actor_betas.npz"

# BEAT v1 roster (actors 1-30 in order): name -> gender, 15 male / 15 female.
NAME_TO_GENDER: dict[str, str] = {
    "wayne": "male", "scott": "male", "solomon": "male", "lawrence": "male",
    "stewart": "male", "carla": "female", "sophie": "female", "catherine": "female",
    "miranda": "female", "kieks": "female", "nidal": "male", "zhao": "male",
    "lu": "male", "zhang": "male", "carlos": "male", "jorge": "male", "itoi": "male",
    "daiki": "male", "jaime": "male", "li": "male", "ayana": "female", "luqi": "female",
    "hailing": "female", "kexin": "female", "goto": "female", "reamey": "female",
    "yingqing": "female", "tiffnay": "female", "hanieh": "female", "katya": "female",
}


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
