"""BEAT facial blendshape utilities (ARKit FACS streams).

The port's copy of ``amuse_tpu/data/facial.py``.

Re-provides dm/utils/facial_utils.py: the ARKit blendshape name groups
(lip-sync vs remaining FACS - public ARKit taxonomy), downsampling of the
60 fps facial JSON to the target fps, and content/emotion stream splitting
used by the legacy face pipeline. numpy-only, host-side.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

# ARKit-52 blendshape taxonomy split into speech-synced (lips/jaw) vs the
# rest (brows/eyes/cheeks) - the reference's v0 grouping.
LIP_SYNC_FACS = (
    "jawOpen", "jawForward", "mouthFunnel", "mouthPucker",
    "mouthLeft", "mouthRight", "mouthRollLower", "mouthRollUpper",
    "mouthShrugLower", "mouthShrugUpper", "mouthClose", "mouthUpperUpLeft",
    "mouthUpperUpRight", "mouthLowerDownLeft", "mouthLowerDownRight",
    "mouthPressLeft", "mouthPressRight", "mouthStretchLeft", "mouthStretchRight",
)
REMAINING_FACS = (
    "browDownLeft", "browDownRight", "browInnerUp", "browOuterUpLeft",
    "browOuterUpRight", "cheekPuff", "cheekSquintLeft", "cheekSquintRight",
    "eyeBlinkLeft", "eyeBlinkRight", "eyeLookDownLeft", "eyeLookDownRight",
    "eyeLookInLeft", "eyeLookInRight", "eyeLookOutLeft", "eyeLookOutRight",
    "eyeLookUpLeft", "eyeLookUpRight", "eyeSquintLeft", "eyeSquintRight",
    "eyeWideLeft", "eyeWideRight", "jawLeft", "jawRight",
    "mouthDimpleLeft", "mouthDimpleRight", "mouthFrownLeft", "mouthFrownRight",
    "mouthSmileLeft", "mouthSmileRight", "noseSneerLeft", "noseSneerRight",
)
COMBINED_FACS = tuple(sorted(LIP_SYNC_FACS + REMAINING_FACS))


def load_facial_json(path) -> dict:
    return json.loads(Path(path).read_text())


def facial_frame_rate(facial: dict, default: float = 60.0) -> float:
    """Estimate the capture fps from frame timestamps (facial_utils.py:47
    samples frames 10..20); short captures fall back to the first/last span
    and degenerate timestamps to ``default`` instead of crashing."""
    frames = facial["frames"]
    if len(frames) > 20:
        dt = (frames[20]["time"] - frames[10]["time"]) / 10.0
    elif len(frames) >= 2:
        dt = (frames[-1]["time"] - frames[0]["time"]) / (len(frames) - 1)
    else:
        return default
    return 1.0 / dt if dt > 0 else default


def process_facial(
    facial: dict, target_fps: int = 30
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Facial JSON -> (lip (T, 19), remaining (T, 32), all (T, 52)) weights,
    decimated from the capture rate to target_fps."""
    names = facial["names"]
    factor = max(1, math.ceil(facial_frame_rate(facial)) // target_fps)
    lip_idx = [names.index(f) for f in LIP_SYNC_FACS if f in names]
    rem_idx = [names.index(f) for f in REMAINING_FACS if f in names]
    lip, rem, full = [], [], []
    for j, frame in enumerate(facial["frames"]):
        if j % factor:
            continue
        w = np.asarray(frame["weights"], np.float32)
        lip.append(w[lip_idx])
        rem.append(w[rem_idx])
        full.append(w)
    if not lip:  # empty/truncated capture: return (0, K) arrays, don't
        # abort a whole dataset pass on np.stack([]) (one bad JSON)
        return (
            np.zeros((0, len(lip_idx)), np.float32),
            np.zeros((0, len(rem_idx)), np.float32),
            np.zeros((0, len(names)), np.float32),
        )
    return np.stack(lip), np.stack(rem), np.stack(full)


def combine_streams(
    lip_from: np.ndarray, rest_from: np.ndarray, names: list[str]
) -> np.ndarray:
    """Recombine a lip-sync stream with another take's remaining-FACS stream
    into a full 52-weight sequence (the face con/emo swap primitive)."""
    t = min(lip_from.shape[0], rest_from.shape[0])
    out = np.zeros((t, len(names)), np.float32)
    for i, f in enumerate([f for f in LIP_SYNC_FACS if f in names]):
        out[:, names.index(f)] = lip_from[:t, i]
    for i, f in enumerate([f for f in REMAINING_FACS if f in names]):
        out[:, names.index(f)] = rest_from[:t, i]
    return out


def standardize(x: np.ndarray, mean=None, std=None, forward: bool = True):
    """Zero-mean/unit-variance (facial_utils std_faces_forward_backward)."""
    if mean is None:
        mean, std = x.mean(axis=0), x.std(axis=0) + 1e-8
    return ((x - mean) / std if forward else x * std + mean), mean, std
