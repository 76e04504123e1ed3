"""Motion feature packing: SMPL-X pose windows <-> model feature vectors.

Port of ``amuse_tpu/core/motion.py``: a 300-frame window at 30 fps of
55 joints x axis-angle(3) + root translation(3) = 168 raw features, or
55 x 6D(6) + 3 = 333 features in the 6D representation.
"""

from __future__ import annotations

import torch

from amuse_tpu_torch.core import rotations

NUM_JOINTS = 55
RAW_FEATS = NUM_JOINTS * 3 + 3  # 168
FEATS_6D = NUM_JOINTS * 6 + 3  # 333
WINDOW_FRAMES = 300  # 10 s at 30 fps
JAW_JOINT = 22  # zeroed when exporting npz


def axis_angle_to_feats6d(motion: torch.Tensor) -> torch.Tensor:
    """(..., T, 168) axis-angle+trans -> (..., T, 333) 6D+trans."""
    poses, trans = motion[..., :-3], motion[..., -3:]
    aa = poses.reshape(poses.shape[:-1] + (NUM_JOINTS, 3))
    d6 = rotations.axis_angle_to_rotation_6d(aa)
    d6 = d6.reshape(d6.shape[:-2] + (NUM_JOINTS * 6,))
    return torch.cat([d6, trans], dim=-1)


def feats6d_to_axis_angle(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, 333) -> poses (..., T, 55, 3) axis-angle and trans (..., T, 3)."""
    d6, trans = feats[..., :-3], feats[..., -3:]
    d6 = d6.reshape(d6.shape[:-1] + (NUM_JOINTS, 6))
    return rotations.rotation_6d_to_axis_angle(d6), trans


def feats3d_split(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, 168) -> poses (..., T, 55, 3) and trans (..., T, 3)."""
    poses, trans = feats[..., :-3], feats[..., -3:]
    return poses.reshape(poses.shape[:-1] + (NUM_JOINTS, 3)), trans


def featurize(motion: torch.Tensor, rep: str = "6D", skip_trans: bool = False) -> torch.Tensor:
    """Raw (..., T, 168) axis-angle+trans -> the configured feature space."""
    if rep == "6D":
        if skip_trans:
            raise ValueError("skip_trans is only valid with smplx_rep='3D'")
        return axis_angle_to_feats6d(motion)
    if rep != "3D":
        raise ValueError(f"smplx_rep must be '6D' or '3D', got {rep!r}")
    return motion[..., :-3] if skip_trans else motion


def defeaturize(
    feats: torch.Tensor, rep: str = "6D", skip_trans: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Feature space -> (poses (..., T, 55, 3) axis-angle, trans (..., T, 3)).

    With ``skip_trans`` the translation was never modelled: returns zeros.
    """
    if rep == "6D":
        return feats6d_to_axis_angle(feats)
    if rep != "3D":
        raise ValueError(f"smplx_rep must be '6D' or '3D', got {rep!r}")
    if skip_trans:
        poses = feats.reshape(feats.shape[:-1] + (NUM_JOINTS, 3))
        return poses, feats.new_zeros(feats.shape[:-1] + (3,))
    return feats3d_split(feats)


def zero_jaw(poses: torch.Tensor) -> torch.Tensor:
    """Copy of ``poses`` (..., 55, 3) with the jaw joint zeroed for export."""
    out = torch.as_tensor(poses).clone()
    out[..., JAW_JOINT, :] = 0.0
    return out


def window_motion(motion: torch.Tensor, frames_per_window: int = WINDOW_FRAMES) -> torch.Tensor:
    """(T, F) -> (T // W, W, F): deterministic non-overlapping windows."""
    n = (motion.shape[0] // frames_per_window) * frames_per_window
    return motion[:n].reshape(-1, frames_per_window, motion.shape[-1])
