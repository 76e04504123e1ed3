"""BVH forward kinematics + motion feature pipelines (the PyMO surface).

The port's copy of ``amuse_tpu/data/motion_features.py`` (numpy, host-side).

Re-provides the reference's PyMO-based featurisation layer
(dm/utils/bvh_utils.py:1185-1537: pymo_pipeline / pymo_inverse_pipeline /
pymo_feats2joints, mean-pose normalisation): joint world positions from a
BVH skeleton, normalised position features, and the inverse transform used
by the legacy (non-SMPL-X) training path's joints loss. The flagship SMPL-X
path bypasses this (its FK is core/smplx.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from amuse_tpu_torch.data.bvh import BvhData


def forward_kinematics(bvh: BvhData) -> np.ndarray:
    """BVH Euler channels -> (T, J, 3) joint world positions (end sites kept).

    Plain numpy FK over the hierarchy; used to featurise legacy BVH data and
    to drive FK-based metrics on raw captures.
    """
    from amuse_tpu_torch.data.bvh import _euler_to_matrix

    t = bvh.num_frames
    n = len(bvh.joints)
    world_rot = [None] * n
    world_pos = np.zeros((t, n, 3))

    col = 0
    for idx, j in enumerate(bvh.joints):
        n_ch = len(j.channels)
        block = bvh.frames[:, col : col + n_ch] if n_ch else None
        col += n_ch

        rot_cols = [i for i, c in enumerate(j.channels) if c.endswith("rotation")]
        pos_cols = [i for i, c in enumerate(j.channels) if c.endswith("position")]
        if rot_cols:
            order = "".join(c[0] for c in j.channels if c.endswith("rotation"))
            local_rot = _euler_to_matrix(block[:, rot_cols], order)
        else:
            local_rot = np.broadcast_to(np.eye(3), (t, 3, 3))
        offset = np.broadcast_to(j.offset, (t, 3)).copy()
        if pos_cols and j.parent == -1:
            offset = offset + block[:, pos_cols]

        if j.parent == -1:
            world_rot[idx] = local_rot
            world_pos[:, idx] = offset
        else:
            pr = world_rot[j.parent]
            world_rot[idx] = np.einsum("tij,tjk->tik", pr, local_rot)
            world_pos[:, idx] = world_pos[:, j.parent] + np.einsum(
                "tij,tj->ti", pr, offset
            )
    return world_pos


@dataclass
class MotionFeaturePipeline:
    """positions <-> normalised flat features, with recorded statistics.

    = the PyMO featurize / inverse pair: fit() records the mean pose and
    per-feature std on training data; transform/inverse round-trip exactly.
    """

    mean: Optional[np.ndarray] = None  # (J*3,)
    std: Optional[np.ndarray] = None

    def fit(self, joints: np.ndarray) -> "MotionFeaturePipeline":
        flat = joints.reshape(joints.shape[0], -1)
        self.mean = flat.mean(axis=0)
        self.std = flat.std(axis=0) + 1e-8
        return self

    def transform(self, joints: np.ndarray) -> np.ndarray:
        """(T, J, 3) -> (T, J*3) normalised features."""
        flat = joints.reshape(joints.shape[0], -1)
        return ((flat - self.mean) / self.std).astype(np.float32)

    def inverse(self, feats: np.ndarray) -> np.ndarray:
        """(T, J*3) features -> (T, J, 3) joint positions (feats2joints)."""
        flat = feats * self.std + self.mean
        return flat.reshape(feats.shape[0], -1, 3)

    def save(self, path) -> None:
        np.savez(path, mean=self.mean, std=self.std)

    @classmethod
    def load(cls, path) -> "MotionFeaturePipeline":
        d = np.load(path)
        return cls(mean=d["mean"], std=d["std"])
