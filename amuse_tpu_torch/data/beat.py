"""BEAT dataset discovery and take-level metadata.

Port of ``amuse_tpu/data/beat.py``: walk a BEAT-style data root laid out as
``<root>/<actor_id>/<actor_id>_<name>_<lang>_<take>_<take>.{wav,bvh,csv}``,
keep English takes, attach the MoSh npz of each take when one exists, and
read the emotion label from the per-take CSV (last value of the final row).
Host-side metadata only; ``data/cache.py`` and ``data/stage1.py`` build the
heavy artefacts.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from amuse_tpu_torch.data.actors import ACTORS, PRETRAINED_TAKE_NUMBERS, STAGE2_ACTOR_IDS


@dataclass(frozen=True)
class Take:
    actor_id: int
    actor_name: str
    take: str  # e.g. "0_9_9"
    wav: Optional[Path]
    bvh: Optional[Path]
    emotion_csv: Optional[Path]
    mosh_npz: Optional[Path]  # SMPL-X MoSh motion, if extracted

    @property
    def take_number(self) -> str:
        return self.take.split("_")[-1]

    @property
    def is_english(self) -> bool:
        # BEAT file stems: <actor>_<name>_<lang>_<take>_<take>; lang 0 = EN
        return self.take.split("_")[0] == "0"


def emotion_label(csv_path: Path) -> int:
    """Emotion id from a BEAT per-take CSV: the last value of the final row.
    A malformed or empty CSV gives 0 (neutral) with a warning, so that one
    bad file does not abort a dataset build."""
    rows = np.atleast_2d(np.genfromtxt(csv_path, delimiter=","))
    if rows.size == 0 or not np.isfinite(rows[-1, -1]):
        warnings.warn(f"unparseable emotion CSV {csv_path}; defaulting to 0", stacklevel=2)
        return 0
    return int(rows[-1, -1])


def _sibling(wav: Path, suffix: str) -> Optional[Path]:
    p = wav.with_suffix(suffix)
    return p if p.exists() else None


def discover(data_root: Path, mosh_root: Optional[Path] = None,
             english_only: bool = True) -> list[Take]:
    """Walk the BEAT tree -> Take records, actors in id order, wavs sorted."""
    data_root = Path(data_root)
    takes: list[Take] = []
    for actor_id, actor in sorted(ACTORS.items()):
        actor_dir = data_root / str(actor_id)
        if not actor_dir.is_dir():
            continue
        for wav in sorted(actor_dir.glob("*.wav")):
            mosh = Path(mosh_root) / f"{wav.stem}.npz" if mosh_root else None
            t = Take(
                actor_id=actor_id,
                actor_name=actor.name,
                take="_".join(wav.stem.split("_")[2:]),
                wav=wav,
                bvh=_sibling(wav, ".bvh"),
                emotion_csv=_sibling(wav, ".csv"),
                mosh_npz=mosh if mosh is not None and mosh.exists() else None,
            )
            if english_only and not t.is_english:
                continue
            takes.append(t)
    return takes


def stage2_subset(takes: list[Take]) -> list[Take]:
    """The stage-2 training takes: the 25 MoSh'd actors, the two takes per
    emotion of the released checkpoints, with both motion and audio."""
    return [
        t for t in takes
        if t.actor_id in STAGE2_ACTOR_IDS
        and t.take_number in PRETRAINED_TAKE_NUMBERS
        and t.mosh_npz is not None
        and t.wav is not None
    ]


def load_mosh_motion(npz_path: Path, fps: float = 30.0) -> np.ndarray:
    """MoSh npz -> (T, 168) [55 joints axis-angle | trans] at ``fps``.

    Honours a recorded ``mocap_frame_rate``: the cache pairs 300-frame
    windows with 10 s audio chunks, which holds only at 30 fps. A capture at
    an integer multiple of ``fps`` (BEAT's 120 fps) is strided down; any
    other rate raises rather than pair audio and motion offset by the ratio.
    """
    with np.load(npz_path, allow_pickle=False) as d:
        poses = np.asarray(d["poses"], np.float32)  # (T, 165)
        trans = np.asarray(d["trans"], np.float32)  # (T, 3)
        rate = (float(np.asarray(d["mocap_frame_rate"]).reshape(()))
                if "mocap_frame_rate" in d.files else fps)
    if rate != fps:
        stride = rate / fps
        if abs(stride - round(stride)) > 1e-6 or stride < 1:
            raise ValueError(
                f"{npz_path}: mocap_frame_rate={rate} is not an integer "
                f"multiple of the pipeline fps={fps}; resample the npz"
            )
        stride = int(round(stride))
        poses, trans = poses[::stride], trans[::stride]
    n = min(poses.shape[0], trans.shape[0])
    return np.concatenate([poses[:n], trans[:n]], axis=-1)
