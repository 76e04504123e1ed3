"""SMPL-X animation export: one Blender-compatible npz per 10 s window.

The port's copy of ``write_smplx_npz`` and ``export_windows`` from
``amuse_tpu/viz/export.py``: keys ``poses`` (T, 55, 3), ``trans`` (T, 3),
``gender``, ``betas`` and ``mocap_frame_rate``, under
``<out_dir>/seq_<i>/<subject>_<stem>_seq<i>_smplx.npz``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from amuse_tpu_torch.data.actors import subject_to_gender_beta


def write_smplx_npz(
    path,
    poses: np.ndarray,  # (T, 55, 3) axis-angle
    trans: np.ndarray,  # (T, 3)
    subject: str = "",
    gender: str | None = None,
    betas: np.ndarray | None = None,
    fps: float = 30.0,
) -> Path:
    """Write the SMPL-X npz of one window."""
    if gender is None or betas is None:
        g, b = subject_to_gender_beta(subject)
        gender = gender or g
        betas = betas if betas is not None else b
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        poses=np.asarray(poses, np.float64),
        trans=np.asarray(trans, np.float64),
        gender=gender,
        betas=np.asarray(betas, np.float64),
        mocap_frame_rate=np.array(fps, dtype="float64"),
    )
    return path


def export_windows(out_dir, result: dict, subject: str = "", stem: str = "motion") -> list[Path]:
    """Export each generated 10 s window as seq_{i}/<subject>_<stem>_seq{i}_smplx.npz."""
    out_dir = Path(out_dir)
    return [
        write_smplx_npz(out_dir / f"seq_{i}" / f"{subject}_{stem}_seq{i}_smplx.npz",
                        poses, trans, subject=subject, fps=result.get("fps", 30.0))
        for i, (poses, trans) in enumerate(zip(result["poses"], result["trans"]))
    ]
