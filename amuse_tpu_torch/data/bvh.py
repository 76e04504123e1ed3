"""BVH motion-capture files: parsing, writing and conversion to SMPL-X npz.

The port's copy of ``amuse_tpu/data/bvh.py``: hierarchy parsing, per-frame
Euler channels, conversion to axis-angle, the retargeted-BVH -> SMPL-X npz
leg of ``bvh2smplx_``, and BVH re-export. Parsing, the Euler matrices
(float64) and writing run on the host in numpy; the axis-angle conversion of
all joints and frames is one ``core.rotations.matrix_to_axis_angle`` call in
float32 on the device the caller names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from amuse_tpu_torch.core.rotations import matrix_to_axis_angle


@dataclass
class BvhJoint:
    name: str
    parent: int  # -1 for root
    offset: np.ndarray  # (3,)
    channels: list[str] = field(default_factory=list)
    is_end_site: bool = False


@dataclass
class BvhData:
    joints: list[BvhJoint]
    frames: np.ndarray  # (T, total_channels)
    frame_time: float

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time

    @property
    def num_frames(self) -> int:
        return self.frames.shape[0]

    def joint_index(self, name: str) -> int:
        for i, j in enumerate(self.joints):
            if j.name == name:
                return i
        raise KeyError(name)


def parse_bvh(path) -> BvhData:
    text = Path(path).read_text()
    joints: list[BvhJoint] = []
    stack: list[int] = []
    frames = []
    frame_time = 1.0 / 30.0
    n_frames = 0
    in_motion = False

    for raw in text.splitlines():
        tok = raw.split()
        if not tok:
            continue
        kw = tok[0].upper()
        if in_motion:
            if kw == "FRAMES:":
                n_frames = int(tok[1])
            elif kw == "FRAME" and tok[1].upper().startswith("TIME"):
                frame_time = float(tok[-1])
            else:
                frames.append([float(x) for x in tok])
        elif kw in ("ROOT", "JOINT"):
            joints.append(BvhJoint(tok[1], stack[-1] if stack else -1, np.zeros(3)))
        elif kw == "END":
            joints.append(BvhJoint(f"{joints[stack[-1]].name}_end", stack[-1], np.zeros(3),
                                   is_end_site=True))
        elif kw == "{":
            stack.append(len(joints) - 1)
        elif kw == "}":
            stack.pop()
        elif kw == "OFFSET":  # applies to the most recently opened node
            joints[stack[-1]].offset = np.asarray([float(x) for x in tok[1:4]])
        elif kw == "CHANNELS":
            joints[stack[-1]].channels = tok[2:]
        elif kw == "MOTION":
            in_motion = True

    data = np.asarray(frames, np.float64)
    if n_frames and data.shape[0] > n_frames:
        data = data[:n_frames]
    return BvhData(joints, data, frame_time)


def _euler_to_matrix(angles_deg: np.ndarray, order: str) -> np.ndarray:
    """Intrinsic Euler (BVH channel order, e.g. 'ZXY') -> (T, 3, 3), float64."""
    t = angles_deg.shape[0]
    m = np.broadcast_to(np.eye(3), (t, 3, 3)).copy()
    rad = np.deg2rad(angles_deg)
    for i, axis in enumerate(order):
        c, s = np.cos(rad[:, i]), np.sin(rad[:, i])
        r = np.zeros((t, 3, 3))
        if axis == "X":
            r[:, 0, 0] = 1
            r[:, 1, 1], r[:, 1, 2] = c, -s
            r[:, 2, 1], r[:, 2, 2] = s, c
        elif axis == "Y":
            r[:, 1, 1] = 1
            r[:, 0, 0], r[:, 0, 2] = c, s
            r[:, 2, 0], r[:, 2, 2] = -s, c
        else:
            r[:, 2, 2] = 1
            r[:, 0, 0], r[:, 0, 1] = c, -s
            r[:, 1, 0], r[:, 1, 1] = s, c
        m = np.einsum("tij,tjk->tik", m, r)
    return m


def joint_matrices(bvh: BvhData) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """-> (local rotations (T, J, 3, 3) float64, root trans (T, 3), joint names)
    over the joints that are not end sites; a joint without rotation channels
    gets the identity."""
    mats, names = [], []
    trans = np.zeros((bvh.num_frames, 3))
    col = 0
    for j in bvh.joints:
        if j.is_end_site:
            continue
        n_ch = len(j.channels)
        block = bvh.frames[:, col:col + n_ch]
        rot_cols = [i for i, c in enumerate(j.channels) if c.endswith("rotation")]
        pos_cols = [i for i, c in enumerate(j.channels) if c.endswith("position")]
        if pos_cols and j.parent == -1:
            trans = block[:, pos_cols]
        if rot_cols:
            order = "".join(c[0] for c in j.channels if c.endswith("rotation"))
            mats.append(_euler_to_matrix(block[:, rot_cols], order))
        else:
            mats.append(np.broadcast_to(np.eye(3), (bvh.num_frames, 3, 3)))
        names.append(j.name)
        col += n_ch
    return np.stack(mats, axis=1), trans, names


def matrices_to_axis_angle(mats: np.ndarray, device="cuda") -> np.ndarray:
    """(..., 3, 3) float64 rotations -> (..., 3) float32 axis-angle, computed in
    float32 on ``device`` (the identity gives exactly zero)."""
    m = torch.as_tensor(np.asarray(mats, np.float32), device=torch.device(device))
    return matrix_to_axis_angle(m).cpu().numpy()


def bvh_to_axis_angle(bvh: BvhData, device="cuda") -> tuple[np.ndarray, np.ndarray, list[str]]:
    """-> (poses (T, J, 3) axis-angle, root trans (T, 3), joint names).

    Euler -> matrix in float64 on the host, then matrix -> axis-angle in
    float32 on ``device``, all joints in one call (JAX's precisions, one joint
    at a time there)."""
    mats, trans, names = joint_matrices(bvh)
    return matrices_to_axis_angle(mats, device), np.asarray(trans, np.float32), names


# ---------------------------------------------------------------------------
# BEAT-retargeted BVH -> SMPL-X npz conversion (the bvh2smplx_ core).
#
# After Auto-Rig-Pro retargets a BEAT capture onto the SMPL-X rig and Blender
# re-exports it as BVH, the file's joint order is not SMPL-X order: slot j of
# the SMPL-X pose takes BVH joint BEAT55_BVH_TO_SMPLX_ORDER[j]. Source joints
# 14-16 (head-end and eye helpers, at slots 22-24 = jaw and eyes) are zeroed.
# The root translation is recentred by the SMPL-X rest-pose root offset (cm)
# and converted to metres.
# ---------------------------------------------------------------------------

BEAT55_BVH_TO_SMPLX_ORDER = np.array([
    0, 1, 5, 9, 2, 6, 10, 3, 7, 11, 4, 8, 12, 17, 36, 13, 18, 37, 19, 38,
    20, 39, 14, 15, 16, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54,
])
ZEROED_SOURCE_JOINTS = (14, 15, 16)  # land at SMPL-X slots 22/23/24
SMPLX_REST_ROOT_OFFSET_CM = np.array([0.31232587, -35.140743, 1.2036551])


def looks_like_smplx_rig(bvh: BvhData) -> bool:
    """True when the skeleton is an (Auto-Rig-Pro-exported) SMPL-X rig: rooted
    at "pelvis", possibly namespaced. A raw BEAT capture (~75 joints rooted at
    "Hips") passes a joint-count check, but the 55-slot reorder map would
    write garbage from it."""
    root = next((j for j in bvh.joints if j.parent == -1), None)
    return root is not None and "pelvis" in root.name.lower()


def retargeted_bvh_to_smplx(bvh: BvhData, device="cuda") -> tuple[np.ndarray, np.ndarray, float]:
    """Retargeted (55+ joint) BVH -> ((T, 55, 3) axis-angle, (T, 3) m, fps).

    The declared channel order is honoured. The returned fps is
    ``ceil(1 / frame_time)`` as in the reference's converter, so a truncated
    30 fps frame time ("0.033333") gives a mocap_frame_rate of 31.
    """
    poses_aa, trans_cm, names = bvh_to_axis_angle(bvh, device)
    if poses_aa.shape[1] < BEAT55_BVH_TO_SMPLX_ORDER.max() + 1:
        raise ValueError(
            f"expected a retargeted SMPL-X skeleton with >= 55 joints, got "
            f"{poses_aa.shape[1]} ({names[:5]}...) - run the Blender "
            "Auto-Rig-Pro retarget step first"
        )
    poses = poses_aa[:, BEAT55_BVH_TO_SMPLX_ORDER].copy()
    poses[:, np.isin(BEAT55_BVH_TO_SMPLX_ORDER, ZEROED_SOURCE_JOINTS)] = 0.0
    trans = (np.asarray(trans_cm, np.float64) - SMPLX_REST_ROOT_OFFSET_CM) / 100.0
    return poses.astype(np.float64), trans, float(np.ceil(bvh.fps))


def write_smplx_take(out_npz, poses, trans, fps: float, subject: str = "") -> Path:
    """The SMPL-X npz of a converted take, with the actor's gender and betas."""
    from amuse_tpu_torch.data.actors import subject_to_gender_beta

    gender, betas = subject_to_gender_beta(subject)
    out_npz = Path(out_npz)
    out_npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        out_npz,
        poses=poses,
        trans=trans,
        gender=np.array(gender, dtype="<U7"),
        mocap_frame_rate=np.array(fps, dtype="float64"),
        betas=np.asarray(betas, np.float64),
    )
    return out_npz


def convert_retargeted_bvh_to_npz(bvh_path, out_npz, subject: str = "",
                                  parsed: BvhData | None = None, device="cuda") -> Path:
    """Parse, reorder, convert and write one take's SMPL-X npz. Pass ``parsed``
    to reuse an already parsed file (BEAT captures are multi-MB text)."""
    data = parsed if parsed is not None else parse_bvh(bvh_path)
    poses, trans, fps = retargeted_bvh_to_smplx(data, device)
    return write_smplx_take(out_npz, poses, trans, fps, subject)


def write_bvh(path, bvh: BvhData) -> Path:
    """Re-export a BvhData (hierarchy + frames) as a BVH file."""
    path = Path(path)
    lines = ["HIERARCHY"]
    children: dict[int, list[int]] = {}
    for i, j in enumerate(bvh.joints):
        children.setdefault(j.parent, []).append(i)

    def emit(idx: int, depth: int):
        j = bvh.joints[idx]
        pad = "  " * depth
        offset = f"{pad}  OFFSET {j.offset[0]:.6f} {j.offset[1]:.6f} {j.offset[2]:.6f}"
        if j.is_end_site:
            lines.extend([f"{pad}End Site", pad + "{", offset, pad + "}"])
            return
        lines.extend([f"{pad}{'ROOT' if j.parent == -1 else 'JOINT'} {j.name}", pad + "{",
                      offset])
        if j.channels:
            lines.append(f"{pad}  CHANNELS {len(j.channels)} " + " ".join(j.channels))
        for c in children.get(idx, []):
            emit(c, depth + 1)
        lines.append(pad + "}")

    for root in children.get(-1, []):
        emit(root, 0)
    lines.append("MOTION")
    lines.append(f"Frames: {bvh.num_frames}")
    lines.append(f"Frame Time: {bvh.frame_time:.8f}")
    for row in bvh.frames:
        lines.append(" ".join(f"{x:.6f}" for x in row))
    path.write_text("\n".join(lines) + "\n")
    return path
