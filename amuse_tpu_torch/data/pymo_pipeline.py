"""PyMO-equivalent BVH featurisation pipelines (the legacy motion path).

The port's copy of ``amuse_tpu/data/pymo_pipeline.py`` (numpy and scipy).

The reference drives its legacy (non-SMPL-X) motion path through PyMO
sklearn pipelines (dm/utils/bvh_utils.py:1672-1745): DownSampler ->
JointSelector -> RootTransformer('pos_rot_deltas'[, _v1], smoothing,
keep_rootTrans/keep_forwardY) -> MocapParameterizer('expmap') -> Numpyfier,
selected by a version tag (``pymo_dB_v{0..5}[_fing]``). The PyMO submodule
itself is EMPTY in the reference checkout (.gitmodules only), so this module
re-provides the same option surface with explicitly documented semantics
rather than bit-parity with an unvendored dependency:

  * **downsample**: integer frame stride to the target fps (DownSampler
    keep_all=False semantics).
  * **joint selection**: named subset, root always included
    (JointSelector include_root=True).
  * **root transform** ``pos_rot_deltas``: the root track is factored into
    ground-plane position deltas expressed in the character's local (yaw)
    frame, the yaw-angle delta, and absolute height; the remaining
    (roll/pitch) root rotation joins the expmap block. The inverse
    integrates the deltas from origin/identity-yaw - like PyMO, a
    round-trip reproduces the motion relative to its start pose.
    ``keep_root_trans`` (the v3 tag) additionally carries the absolute
    X/Z track through untouched.
  * **expmap**: per-joint intrinsic BVH Euler -> exponential-map
    (axis-angle) triple; exact inverse back to each joint's channel order.
  * smoothing windows (``position_smoothing``/``rotation_smoothing``,
    frames) are centred moving averages applied before the deltas - the
    role PyMO's filtfilt smoothing plays in the v0 tag.

Everything here is host-side numpy preprocessing (one-time, cached), so it
deliberately stays off the GPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation as _R

from amuse_tpu_torch.data.bvh import BvhData

_EPS = 1e-9


# ---------------------------------------------------------------------------
# options / version tags
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PymoOptions:
    tgt_fps: int = 30
    joints: Optional[tuple[str, ...]] = None  # None = all non-end-site joints
    root_transform: str = "pos_rot_deltas"  # "none" | "pos_rot_deltas"
    position_smoothing: int = 0  # centred moving-average window (frames)
    rotation_smoothing: int = 0
    keep_root_trans: bool = False  # v3: carry absolute X/Z through


def options_for_version(version: str, tgt_fps: int = 30) -> PymoOptions:
    """Map the reference's ``pymo_dB_v{0..5}[_fing]`` tags to options
    (bvh_utils.py:1683-1732). v4/v5 (pos_rot_deltas_v1 variants) are mapped
    onto the same delta transform - upstream marks both as rejected
    ("sliding alot"), v0/v2 are the used ones."""

    def has(tag: str) -> bool:
        # match "_vN" at a segment boundary OR end of string, so both
        # "pymo_dB_v1_fing" and the suffix-less "pymo_dB_v1" resolve
        return f"{tag}_" in version or version.endswith(tag)

    if has("_v1"):
        return PymoOptions(tgt_fps=tgt_fps, root_transform="none")
    if has("_v0"):
        return PymoOptions(
            tgt_fps=tgt_fps, position_smoothing=5, rotation_smoothing=10
        )
    if has("_v3") or has("_v4") or has("_v5"):
        return PymoOptions(tgt_fps=tgt_fps, keep_root_trans=True)
    return PymoOptions(tgt_fps=tgt_fps)  # v2: deltas, no smoothing (Used)


# ---------------------------------------------------------------------------
# small numerics
# ---------------------------------------------------------------------------


def _smooth(x: np.ndarray, window: int) -> np.ndarray:
    """Centred moving average along axis 0 (edge-padded); window<=1 = no-op."""
    if window <= 1:
        return x
    pad = window // 2
    xp = np.pad(x, [(pad, window - 1 - pad)] + [(0, 0)] * (x.ndim - 1), mode="edge")
    kernel = np.ones(window) / window
    return np.apply_along_axis(lambda v: np.convolve(v, kernel, mode="valid"), 0, xp)


def _euler_to_mats(block_deg: np.ndarray, order: str) -> np.ndarray:
    return _R.from_euler(order, block_deg, degrees=True).as_matrix()


def _mats_to_euler(mats: np.ndarray, order: str) -> np.ndarray:
    return _R.from_matrix(mats).as_euler(order, degrees=True)


def _mats_to_expmap(mats: np.ndarray) -> np.ndarray:
    return _R.from_matrix(mats).as_rotvec()


def _expmap_to_mats(aa: np.ndarray) -> np.ndarray:
    return _R.from_rotvec(aa).as_matrix()


def _yaw_decompose(mats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """R -> (yaw angle about +Y, residual) with R = Ry(yaw) @ residual.

    yaw follows the character's forward (+Z) axis projected on the ground
    plane; degenerate (straight up/down) frames keep the previous yaw.
    """
    fwd = mats[:, :, 2]  # rotated +Z
    yaw = np.arctan2(fwd[:, 0], fwd[:, 2])
    flat = np.hypot(fwd[:, 0], fwd[:, 2]) < _EPS
    for t in np.nonzero(flat)[0]:
        yaw[t] = yaw[t - 1] if t else 0.0
    ry = _R.from_euler("Y", -yaw[:, None]).as_matrix()  # undo yaw
    residual = np.einsum("tij,tjk->tik", ry, mats)
    return yaw, residual


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@dataclass
class PymoPipeline:
    """fit on one skeleton, then transform/inverse clips of it.

    Feature layout per frame (Numpyfier analog, fixed order):
      [root block | expmap of joint 0 (root residual) | expmap joint 1 | ...]
    root block = (dx_local, dz_local, y_abs, dyaw) for pos_rot_deltas
    (+ absolute x, z appended when keep_root_trans), or (x, y, z) raw when
    root_transform="none".
    """

    opts: PymoOptions = field(default_factory=PymoOptions)
    joint_names: list[str] = field(default_factory=list)
    joint_orders: list[str] = field(default_factory=list)
    skeleton: Optional[BvhData] = None
    src_fps: float = 30.0

    # ---- fitting --------------------------------------------------------

    def fit(self, bvh: BvhData) -> "PymoPipeline":
        real = [j for j in bvh.joints if not j.is_end_site and j.channels]
        wanted = (
            [j for j in real if j.name in set(self.opts.joints) or j.parent == -1]
            if self.opts.joints
            else real
        )
        self.joint_names = [j.name for j in wanted]
        self.joint_orders = [
            "".join(c[0] for c in j.channels if c.endswith("rotation"))
            for j in wanted
        ]
        self.skeleton = bvh
        self.src_fps = bvh.fps
        return self

    # ---- helpers --------------------------------------------------------

    def _stride(self) -> int:
        return max(1, int(round(self.src_fps / self.opts.tgt_fps)))

    def _joint_blocks(self, bvh: BvhData):
        """-> {name: (rot_block_deg, order, pos_block | None)} downsampled."""
        sel = set(self.joint_names)
        out = {}
        col = 0
        stride = self._stride()
        for j in bvh.joints:
            n_ch = len(j.channels)
            block = bvh.frames[::stride, col : col + n_ch]
            col += n_ch
            if j.is_end_site or j.name not in sel:
                continue
            rot_cols = [i for i, c in enumerate(j.channels) if c.endswith("rotation")]
            pos_cols = [i for i, c in enumerate(j.channels) if c.endswith("position")]
            order = "".join(c[0] for c in j.channels if c.endswith("rotation"))
            out[j.name] = (
                block[:, rot_cols],
                order,
                block[:, pos_cols] if pos_cols else None,
            )
        return out

    # ---- transform ------------------------------------------------------

    def transform(self, bvh: BvhData) -> np.ndarray:
        """BVH -> (T', D) float32 feature clip."""
        blocks = self._joint_blocks(bvh)
        root = self.joint_names[0]
        rot_deg, order, pos = blocks[root]
        if pos is None:
            pos = np.zeros((rot_deg.shape[0], 3))
        mats = _euler_to_mats(rot_deg, order)

        cols = []
        if self.opts.root_transform == "pos_rot_deltas":
            pos_s = _smooth(pos, self.opts.position_smoothing)
            yaw, residual = _yaw_decompose(mats)
            # unwrap BEFORE smoothing: averaging wrapped angles across the
            # +-pi branch cut (e.g. 3.1 and -3.1) yields garbage near 0
            yaw = _smooth(np.unwrap(yaw)[:, None], self.opts.rotation_smoothing)[:, 0]
            dyaw = np.diff(yaw, prepend=yaw[:1])
            dpos = np.diff(pos_s[:, [0, 2]], axis=0, prepend=pos_s[:1, [0, 2]])
            # express ground deltas in the PREVIOUS frame's yaw-local frame
            yaw_prev = np.concatenate([yaw[:1], yaw[:-1]])
            c, s = np.cos(yaw_prev), np.sin(yaw_prev)
            dx_l = c * dpos[:, 0] - s * dpos[:, 1]
            dz_l = s * dpos[:, 0] + c * dpos[:, 1]
            cols.append(np.stack([dx_l, dz_l, pos_s[:, 1], dyaw], axis=1))
            if self.opts.keep_root_trans:
                cols.append(pos_s[:, [0, 2]])
            cols.append(_mats_to_expmap(residual))
        else:
            cols.append(pos)
            cols.append(_mats_to_expmap(mats))

        for name in self.joint_names[1:]:
            rot_deg, order, _ = blocks[name]
            cols.append(_mats_to_expmap(_euler_to_mats(rot_deg, order)))
        return np.concatenate(cols, axis=1).astype(np.float32)

    # ---- inverse --------------------------------------------------------

    def inverse(self, feats: np.ndarray) -> BvhData:
        """(T, D) features -> BvhData on the fitted skeleton (tgt fps)."""
        assert self.skeleton is not None, "fit() first"
        t = feats.shape[0]
        i = 0
        if self.opts.root_transform == "pos_rot_deltas":
            dx_l, dz_l, y_abs, dyaw = feats[:, 0], feats[:, 1], feats[:, 2], feats[:, 3]
            i = 4
            if self.opts.keep_root_trans:
                abs_xz = feats[:, i : i + 2]
                i += 2
            yaw = np.cumsum(dyaw) - dyaw[0]
            yaw_prev = np.concatenate([yaw[:1], yaw[:-1]])
            c, s = np.cos(yaw_prev), np.sin(yaw_prev)
            dx_w = c * dx_l + s * dz_l
            dz_w = -s * dx_l + c * dz_l
            x = np.cumsum(dx_w) - dx_w[0]
            z = np.cumsum(dz_w) - dz_w[0]
            if self.opts.keep_root_trans:
                x, z = abs_xz[:, 0], abs_xz[:, 1]
            pos = np.stack([x, y_abs, z], axis=1)
            residual = _expmap_to_mats(feats[:, i : i + 3])
            i += 3
            ry = _R.from_euler("Y", yaw[:, None]).as_matrix()
            root_mats = np.einsum("tij,tjk->tik", ry, residual)
        else:
            pos = feats[:, 0:3]
            root_mats = _expmap_to_mats(feats[:, 3:6])
            i = 6

        joint_mats = {self.joint_names[0]: root_mats}
        for name in self.joint_names[1:]:
            joint_mats[name] = _expmap_to_mats(feats[:, i : i + 3])
            i += 3

        # rebuild the frame matrix on the fitted skeleton's channel layout
        total_ch = sum(len(j.channels) for j in self.skeleton.joints)
        frames = np.zeros((t, total_ch), np.float64)
        col = 0
        for jidx, j in enumerate(self.skeleton.joints):
            n_ch = len(j.channels)
            if j.name in joint_mats and not j.is_end_site:
                order = self.joint_orders[self.joint_names.index(j.name)]
                eulers = _mats_to_euler(joint_mats[j.name], order)
                rot_cols = [
                    k for k, c in enumerate(j.channels) if c.endswith("rotation")
                ]
                frames[:, [col + k for k in rot_cols]] = eulers
                pos_cols = [
                    k for k, c in enumerate(j.channels) if c.endswith("position")
                ]
                if pos_cols and j.parent == -1:
                    frames[:, [col + k for k in pos_cols]] = pos
            col += n_ch

        return BvhData(
            joints=list(self.skeleton.joints),
            frames=frames,
            frame_time=1.0 / self.opts.tgt_fps,
        )

    def fit_transform(self, bvh: BvhData) -> np.ndarray:
        return self.fit(bvh).transform(bvh)


def feats_to_joints(pipe: PymoPipeline, feats: np.ndarray) -> np.ndarray:
    """pymo_feats2joints analog: features -> (T, J, 3) world positions."""
    from amuse_tpu_torch.data.motion_features import forward_kinematics

    return forward_kinematics(pipe.inverse(feats))
