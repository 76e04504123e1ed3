"""SMPL-X body model (shape blendshapes + pose correctives + LBS) in torch.

Port of ``amuse_tpu/core/smplx.py``. The forward is a function over a
:class:`SmplxModel` of float32 tensors. The reference runs the ``smplx``
package in float64 for its vertex-displacement loss; float32 agrees to
~1e-5 m on centimetre-scale vertices (``tests/test_smplx.py``).

Model data layout matches the published SMPL-X npz artefacts (v_template,
shapedirs, posedirs, J_regressor, lbs_weights/weights, kintree_table).
Those files ship with SMPL-X licensing and are not bundled; load them with
:func:`load_model`.

SMPL-X pose vector layout (latent_losses.py:237-250):
  [0:3]    global_orient     [3:66]  body (21 joints)
  [66:69]  jaw               [69:75] eyes
  [75:120] left hand         [120:165] right hand      -> 55 joints total

The JAX package lays the monitor forward out as 2D "slabs" because a
trailing (3, 3) pads ~40x in TPU memory. A GPU has no such padding, so
:func:`soc_monitor_vertices` here runs the same math batched over frames,
with the two pieces that make it cheap: ONE pose-corrective product
(N, 9 (J-1)) @ (9 (J-1), 3V), and the shape correction once per window.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from amuse_tpu_torch.core.rotations import axis_angle_to_matrix, rotation_6d_to_matrix

NUM_JOINTS = 55
NUM_BODY_BETAS = 300  # reference uses 300-beta MoSh shapes (latent_losses.py:192)

# The published SMPL-X kinematic tree (kintree_table row 0 of the released
# npz): pelvis-rooted body chain, jaw/eyes off the head, 15 finger joints per
# wrist. Its depth is 10, which the level-scheduled FK below exploits.
SMPLX_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int32,
)


class SmplxModel(NamedTuple):
    """Static model tensors (float32, on one device)."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, n_betas + n_expr)
    posedirs: torch.Tensor  # (9 (J-1), V*3), rows joint-major
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray  # (J,) host-side int32, parents[0] == -1
    # Analytic joint tables (the J_regressor folded through the template and
    # shape basis): joints_rest = j_template + j_shapedirs . coeffs, equal to
    # j_regressor @ v_shaped by linearity. REQUIRED when the vertex set is
    # subsampled (j_regressor spans the full mesh); optional otherwise.
    j_template: Optional[torch.Tensor] = None  # (J, 3)
    j_shapedirs: Optional[torch.Tensor] = None  # (J, 3, n_coeffs)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    def to(self, device) -> "SmplxModel":
        return SmplxModel(*(x.to(device) if torch.is_tensor(x) else x for x in self))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def load_model(path, num_betas: int = NUM_BODY_BETAS, num_expr: int = 10) -> SmplxModel:
    """Load a published SMPLX_{NEUTRAL,MALE,FEMALE}.npz (on the CPU).

    ``shapedirs`` in the npz is (V, 3, 400) = 300 shape + 100 expression for
    the MoSh-compatible models; ``num_betas`` shape and ``num_expr``
    expression directions are kept, as ``smplx.create(num_betas=300,
    num_expression_coeffs=10)`` does.
    """
    d = np.load(path, allow_pickle=True)
    shapedirs = np.asarray(d["shapedirs"], np.float32)
    total = shapedirs.shape[-1]
    if total > NUM_BODY_BETAS:
        # dims [0, 300) are shape, [300, 400) expression: smplx.create takes
        # shapedirs[:, :, 300:300+num_expr]
        n_shape = min(num_betas, NUM_BODY_BETAS)
        expr = shapedirs[..., NUM_BODY_BETAS : NUM_BODY_BETAS + num_expr]
        dirs = np.concatenate([shapedirs[..., :n_shape], expr], axis=-1)
    else:
        dirs = shapedirs[..., : min(num_betas, total)]
    posedirs = np.asarray(d["posedirs"], np.float32)
    if posedirs.ndim == 3:  # (V, 3, P) -> (P, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    weights_key = "lbs_weights" if "lbs_weights" in d else "weights"
    parents = np.asarray(d["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    return SmplxModel(
        v_template=_f32(d["v_template"]),
        shapedirs=_f32(dirs),
        posedirs=_f32(posedirs),
        j_regressor=_f32(d["J_regressor"]),
        lbs_weights=_f32(d[weights_key]),
        parents=parents.astype(np.int32),
    )


def make_test_model(
    num_vertices: int = 64,
    num_joints: int = 6,
    num_betas: int = 8,
    seed: int = 0,
    parents: Optional[np.ndarray] = None,
) -> SmplxModel:
    """Synthetic rig for tests and measurements (the JAX package's draws, so
    both packages build the same rig from a seed).

    The default skeleton is a chain; ``parents=SMPLX_PARENTS`` (with
    num_joints=55) gives the released tree's topology.
    """
    rng = np.random.default_rng(seed)
    v_template = rng.normal(size=(num_vertices, 3)).astype(np.float32)
    shapedirs = 0.01 * rng.normal(size=(num_vertices, 3, num_betas)).astype(np.float32)
    posedirs = 0.001 * rng.normal(size=((num_joints - 1) * 9, num_vertices * 3)).astype(np.float32)
    j_reg = rng.dirichlet(np.ones(num_vertices), size=num_joints).astype(np.float32)
    lbs = rng.dirichlet(np.ones(num_joints), size=num_vertices).astype(np.float32)
    if parents is None:
        parents = np.arange(-1, num_joints - 1, dtype=np.int32)
    else:
        parents = np.asarray(parents, np.int32)
        if parents.shape[0] != num_joints:
            raise ValueError("parents table must match num_joints")
    return SmplxModel(
        v_template=_f32(v_template),
        shapedirs=_f32(shapedirs),
        posedirs=_f32(posedirs),
        j_regressor=_f32(j_reg),
        lbs_weights=_f32(lbs),
        parents=parents,
    )


def subsample_vertices(model: SmplxModel, n: int, seed: int = 0) -> SmplxModel:
    """A model whose vertex set is a fixed random subset of ``n`` vertices.

    Per-vertex outputs are exact: each vertex's LBS depends only on its own
    rows and the joint transforms, and the joints are regressed through the
    folded ``j_template``/``j_shapedirs`` tables. So the vertex monitor
    becomes an unbiased mean over n of the V vertices at ~n/V of the LBS
    cost. The subset is deterministic in ``seed`` (the JAX package's draw).
    """
    v = model.num_vertices
    if n >= v:
        return model
    idx = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(v, size=n, replace=False)))
    j_template = (model.j_template if model.j_template is not None
                  else model.j_regressor @ model.v_template)
    j_shapedirs = (model.j_shapedirs if model.j_shapedirs is not None
                   else torch.einsum("jv,vck->jck", model.j_regressor, model.shapedirs))
    posedirs = model.posedirs.reshape(model.posedirs.shape[0], v, 3)
    return SmplxModel(
        v_template=model.v_template[idx],
        shapedirs=model.shapedirs[idx],
        posedirs=posedirs[:, idx].reshape(model.posedirs.shape[0], -1),
        j_regressor=model.j_regressor[:, idx],  # shape-consistent; unused
        lbs_weights=model.lbs_weights[idx],
        parents=model.parents,
        j_template=j_template,
        j_shapedirs=j_shapedirs,
    )


@functools.lru_cache(maxsize=16)
def _fk_schedule(parents_key: tuple) -> tuple:
    """Static level schedule for a parent table: joints grouped by tree depth.

    Returns (levels, level_parent_pos, pos): ``levels[d]`` holds the joint
    indices at depth d, ``level_parent_pos[d]`` their parents' positions in
    the depth-major ordering, and ``pos`` maps joint index -> depth-major
    position.
    """
    parents = np.asarray(parents_key)
    j = parents.shape[0]
    if j > 1 and not (parents[1:] < np.arange(1, j)).all():
        raise ValueError("kinematic tree must be topologically ordered (parents[i] < i)")
    depth = np.zeros(j, np.int64)
    for i in range(1, j):
        if parents[i] >= 0:
            depth[i] = depth[parents[i]] + 1
    order = np.argsort(depth, kind="stable")
    pos = np.empty(j, np.int64)
    pos[order] = np.arange(j)
    levels = [order[depth[order] == d] for d in range(int(depth.max()) + 1)]
    level_parent_pos = [None] + [pos[parents[idx]] for idx in levels[1:]]
    return tuple(map(tuple, levels)), tuple(
        None if p is None else tuple(p) for p in level_parent_pos
    ), tuple(pos)


@functools.lru_cache(maxsize=16)
def _fk_index(parents_key: tuple, device: torch.device) -> tuple:
    """The FK's index tensors on ``device``, made once per tree and device
    (a copy from host memory per use would wait for the device each time):
    (parent index, has-parent mask (J, 1), levels, level_parent_pos, the
    depth-major -> joint order permutation)."""
    parents = np.asarray(parents_key)
    levels, level_parent_pos, pos = _fk_schedule(parents_key)

    def index(p):
        return None if p is None else torch.as_tensor(np.asarray(p), device=device)

    return (index(np.maximum(parents, 0)), torch.as_tensor(parents >= 0, device=device)[:, None],
            tuple(map(index, levels)), tuple(map(index, level_parent_pos)), index(pos))


def _rigid_transforms(rot_mats: torch.Tensor, joints: torch.Tensor,
                      parents: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the tree -> world transforms per joint.

    rot_mats (..., J, 3, 3), joints (..., J, 3) rest positions. Returns
    (posed_joints (..., J, 3), rel_transforms (..., J, 4, 4)), where
    rel_transforms maps rest-pose skinning space to world ("A - A @ [j; 0]").
    All joints at one tree depth compose in one batched product, so the
    released tree takes 10 steps, not 54.
    """
    par, has_parent, levels, level_parent_pos, inv = _fk_index(
        tuple(int(p) for p in np.asarray(parents)), joints.device)
    rel_joints = joints - torch.where(has_parent, joints[..., par, :], 0.0)
    # depth-major accumulation: parents always lie in the built prefix
    r_cat = rot_mats[..., levels[0], :, :]
    t_cat = rel_joints[..., levels[0], :]
    for idx, par_pos in zip(levels[1:], level_parent_pos[1:]):
        rp = r_cat[..., par_pos, :, :]
        r_cat = torch.cat([r_cat, rp @ rot_mats[..., idx, :, :]], dim=-3)
        t_cat = torch.cat([t_cat, (rp @ rel_joints[..., idx, :, None])[..., 0]
                           + t_cat[..., par_pos, :]], dim=-2)
    world_rot = r_cat[..., inv, :, :]  # back to joint order
    posed_joints = t_cat[..., inv, :]
    # remove the rest-pose joint location for skinning
    correction = (world_rot @ joints[..., None])[..., 0]
    top = torch.cat([world_rot, (posed_joints - correction)[..., None]], dim=-1)  # (..., J, 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return posed_joints, torch.cat([top, bottom], dim=-2)


class SocTables(NamedTuple):
    """Model tables laid out for the monitor forward :func:`soc_monitor_vertices`
    (the JAX package's name; there its "structure of slabs"). Components are
    the major axis of every vertex table, so its output is (3, N, V). The
    inner dimension of both products is padded with zero rows to a multiple
    of 8 (55 joints -> 56, 486 pose features -> 488): rows of 16-byte
    multiples let cuBLAS take its aligned float32 kernels (at K = 55 it ran
    ~4 TFLOP/s on an H100)."""

    shaped_c: torch.Tensor  # (1 + K, 3V): v_template row, then shapedirs,
    # columns component-major (all x | all y | all z)
    posedirs_cm: torch.Tensor  # (9 (J-1) padded, 3V): rows joint-major,
    # columns component-major - ONE product for all three components
    lbs_weights_t: torch.Tensor  # (J padded, V)
    joints_c: torch.Tensor  # (1 + K, J*3): j_template row, then j_shapedirs


def _pad_rows(x: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``multiple`` rows."""
    return torch.nn.functional.pad(x, (0, 0, 0, -x.shape[0] % multiple))


def prepare_soc(model: SmplxModel) -> SocTables:
    """One-time reorganisation of the model tensors for the monitor forward,
    on the model's device."""
    v, j = model.num_vertices, model.num_joints
    jt = (model.j_template if model.j_template is not None
          else model.j_regressor @ model.v_template)
    jsh = (model.j_shapedirs if model.j_shapedirs is not None
           else torch.einsum("jv,vck->jck", model.j_regressor, model.shapedirs))
    shaped = torch.cat([model.v_template[..., None], model.shapedirs], dim=-1)  # (V, 3, 1+K)
    joints = torch.cat([jt[..., None], jsh], dim=-1)  # (J, 3, 1+K)
    return SocTables(
        shaped_c=shaped.permute(2, 1, 0).reshape(-1, 3 * v).contiguous(),
        posedirs_cm=_pad_rows(model.posedirs.reshape(-1, v, 3).transpose(1, 2)
                              .reshape(-1, 3 * v)).contiguous(),
        lbs_weights_t=_pad_rows(model.lbs_weights.T).contiguous(),
        joints_c=joints.permute(2, 0, 1).reshape(-1, 3 * j).contiguous(),
    )


# frames skinned at once: the (frames, 3, 4, V) skinning transforms of a
# chunk take at most this many float32 elements (1 GiB)
_SKIN_CHUNK_ELEMENTS = 1 << 28


def soc_monitor_vertices(
    model: SmplxModel,
    soc: SocTables,
    feats6d: torch.Tensor,  # (B, T, joints*6 + 3) 6D motion feats
    betas: torch.Tensor,  # (B, n_betas), constant per window
) -> torch.Tensor:
    """(B, T, F) 6D windows -> posed vertices as a (3, B*T, V) stack.

    The vertex-monitor forward of the train step: equal to ``forward_batch``
    over the flattened frames (the JAX package's ``soc_monitor_vertices``,
    same order of output). It reads the 6D features directly (the rotation
    is the same as through axis-angle).
    """
    b, t, f = feats6d.shape
    j, v = model.num_joints, model.num_vertices
    n = b * t
    mj = (f - 3) // 6
    rot = rotation_6d_to_matrix(feats6d[..., : mj * 6].reshape(n, mj, 6)[:, :j])  # (N, J, 3, 3)
    trans = feats6d[..., -3:].reshape(n, 3)

    # the shape correction once per window, broadcast to its frames
    k_dim = soc.shaped_c.shape[0] - 1
    nb = min(betas.shape[-1], k_dim)
    coeffs = torch.zeros((b, 1 + k_dim), dtype=feats6d.dtype, device=feats6d.device)
    coeffs[:, 0] = 1.0
    coeffs[:, 1 : 1 + nb] = betas[:, :nb]
    v_shaped = (coeffs @ soc.shaped_c).view(b, 1, 3, v)
    j_rest = (coeffs @ soc.joints_c).view(b, 1, j, 3).expand(b, t, j, 3).reshape(n, j, 3)

    # pose correctives: ONE (N, 9 (J-1)) @ (9 (J-1), 3V) product
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    pose_feature = torch.zeros((n, soc.posedirs_cm.shape[0]), dtype=rot.dtype,
                               device=rot.device)
    pose_feature[:, : 9 * (j - 1)] = (rot[:, 1:] - eye).reshape(n, -1)
    v_posed = ((pose_feature @ soc.posedirs_cm).view(b, t, 3, v) + v_shaped).view(n, 3, v)

    _, transforms = _rigid_transforms(rot, j_rest, model.parents)
    rel = torch.zeros((n, 3, 4, soc.lbs_weights_t.shape[0]), dtype=rot.dtype, device=rot.device)
    rel[..., :j] = transforms[:, :, :3].permute(0, 2, 3, 1)  # (N, 3, 4, J padded)
    out = torch.empty((3, n, v), dtype=feats6d.dtype, device=feats6d.device)
    step = max(1, _SKIN_CHUNK_ELEMENTS // (12 * v))
    for s in range(0, n, step):
        e = min(n, s + step)
        skin = rel[s:e] @ soc.lbs_weights_t  # (n, 3, 4, V): the skinning transforms
        verts = skin[:, :, 3] + trans[s:e, :, None]
        for k in range(3):
            verts.addcmul_(skin[:, :, k], v_posed[s:e, None, k])
        out[:, s:e] = verts.transpose(0, 1)
    return out


def forward_batch(model: SmplxModel, poses: torch.Tensor, betas: torch.Tensor,
                  transl: torch.Tensor, expression: Optional[torch.Tensor] = None,
                  return_vertices: bool = True) -> dict:
    """Batched frames -> dict(vertices (N, V, 3), joints (N, J, 3)).

    poses (N, J*3) axis-angle, betas (N, n_betas), transl (N, 3), expression
    None | (E,) shared | (N, E) per frame.
    """
    n, nj = poses.shape[0], model.num_joints
    coeff_dim = model.shapedirs.shape[-1]
    if expression is None:
        expr = betas.new_zeros((n, max(coeff_dim - betas.shape[-1], 0)))
    else:
        expr = expression.expand(n, -1) if expression.dim() == 1 else expression
    coeffs = torch.cat([betas, expr.to(betas.dtype)], dim=-1)[:, :coeff_dim]
    if coeffs.shape[-1] < coeff_dim:  # zero-pad any remaining coefficient dims
        coeffs = torch.nn.functional.pad(coeffs, (0, coeff_dim - coeffs.shape[-1]))

    v_shaped = model.v_template + torch.einsum("vck,nk->nvc", model.shapedirs, coeffs)
    if model.j_template is not None:
        # folded regressor: exact, and the only valid path on a
        # vertex-subsampled model (j_regressor spans the full mesh)
        joints_rest = model.j_template + torch.einsum("jck,nk->njc", model.j_shapedirs, coeffs)
    else:
        joints_rest = torch.einsum("jv,nvc->njc", model.j_regressor, v_shaped)

    rot_mats = axis_angle_to_matrix(poses.reshape(n, nj, 3))
    posed_joints, rel = _rigid_transforms(rot_mats, joints_rest, model.parents)
    out = {"joints": posed_joints + transl[:, None]}
    if return_vertices:
        eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[:, 1:] - eye).reshape(n, -1)
        v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(v_shaped.shape)
        skin = torch.einsum("vj,njab->nvab", model.lbs_weights, rel[:, :, :3])  # (N, V, 3, 4)
        verts = (skin[..., :3] @ v_posed[..., None])[..., 0] + skin[..., 3]
        out["vertices"] = verts + transl[:, None]
    return out


def forward(model: SmplxModel, poses: torch.Tensor, betas: torch.Tensor,
            transl: torch.Tensor, expression: Optional[torch.Tensor] = None,
            return_vertices: bool = True) -> dict:
    """Single frame: poses (J*3,), betas (n_betas,), transl (3,) ->
    dict(vertices (V, 3), joints (J, 3))."""
    out = forward_batch(model, poses[None], betas[None], transl[None],
                        None if expression is None else expression[None], return_vertices)
    return {k: x[0] for k, x in out.items()}
