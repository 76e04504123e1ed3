"""The port's stage-2 training slice (``--fn train_gesture``) against the JAX package (CPU).

Small widths (prior and denoiser d 16, ff 32, 3 layers, 2 heads; 12-frame
windows; 3 DDIM steps), float32 on both sides, inputs from numpy seeds.
JAX parameters reach the port through ``convert.prior_from_jax`` /
``denoiser_from_jax``, which also carry JAX gradient and parameter trees for
the comparisons (their maps are linear). Randomness is injected into both
sides (reparameterisation noise, t, epsilon, the monitor's initial latents)
and dropout is off on both, as the stage-1 tests do. The SMPL-X rigs are
``make_test_model`` (no SMPL-X file is in the repository). Kernel K3, the
monitor's sampler on the card, is held against its plain loop over the
updated weights by tests/test_torch_port_gpu.py and chip_smoke.py.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.core import motion as jmotion
from amuse_tpu.core import smplx as jsmplx
from amuse_tpu.core.rotations import axis_angle_to_matrix as j_aa_to_matrix
from amuse_tpu.data.prefetch import prefetch_to_device as jprefetch
from amuse_tpu.diffusion import add_noise as jadd_noise
from amuse_tpu.diffusion import ddim_sample as jddim_sample
from amuse_tpu.diffusion import make_schedule as jmake_schedule
from amuse_tpu.models import ast as jast
from amuse_tpu.models import denoiser as jden
from amuse_tpu.models import transformer as jtr
from amuse_tpu.models import vae as jvae
from amuse_tpu.train import losses as jL
from amuse_tpu.train.fused_adam import make_fused_adam
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch import convert
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.core import smplx
from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
from amuse_tpu_torch.data.prefetch import prefetch_to_device
from amuse_tpu_torch.diffusion.schedulers import add_noise, make_schedule
from amuse_tpu_torch.models import ast as tast
from amuse_tpu_torch.models import transformer as ttr
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from amuse_tpu_torch.train import gesture as tg
from amuse_tpu_torch.train import losses as L
from amuse_tpu_torch.train.audio import step_generator
from amuse_tpu_torch.train.checkpoint import CheckpointManager
from amuse_tpu_torch.utils import checkpoint_io as cio
from amuse_tpu_torch.utils.logging import RunLogger
from tests.torch_port_pipes import write_take

CPU = torch.device("cpu")
T, B, STEPS, COND, LR = 12, 3, 3, 24, 1e-4
PRIOR_KW = dict(nfeats=333, latent_dim=16, ff_size=32, num_layers=3, num_heads=2, window=T)
DEN_KW = dict(latent_dim=16, ff_size=32, num_layers=3, num_heads=2, cond_dim=COND)
N_BETAS = 16


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ SMPL-X

def _rig(kind: str, seed: int = 0):
    """(JAX rig, port rig) built from the same seed."""
    kw = {"chain": {}, "tree": dict(num_vertices=48, num_joints=55, num_betas=N_BETAS,
                                    parents=jsmplx.SMPLX_PARENTS)}[kind.split("_")[0]]
    j, t = jsmplx.make_test_model(seed=seed, **kw), smplx.make_test_model(seed=seed, **kw)
    if kind.endswith("_sub"):
        j, t = jsmplx.subsample_vertices(j, 20, seed=3), smplx.subsample_vertices(t, 20, seed=3)
    return j, t


_feats6d = jax.jit(jmotion.axis_angle_to_feats6d)


def _frames(m, n: int, seed: int):
    k = m.shapedirs.shape[-1]
    return (_np(seed, n, m.num_joints * 3, scale=0.3), _np(seed + 1, n, k),
            _np(seed + 2, n, 3, scale=0.5))


class TestSmplxAgainstJax:
    @pytest.mark.parametrize("kind", ["chain", "tree", "tree_sub"])
    def test_tables_forward_batch_and_forward(self, kind):
        """The rig, forward_batch and forward: vertices and joints atol 1e-5
        (float32 LBS on unit-scale rigs; readings ~1e-6)."""
        jm, tm = _rig(kind)
        for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
        np.testing.assert_array_equal(tm.parents, jm.parents)
        poses, betas, transl = _frames(jm, 4, 1)
        want = jax.jit(lambda *a: jsmplx.forward_batch(jm, *a))(poses, betas, transl)
        got = smplx.forward_batch(tm, *map(_t, (poses, betas, transl)))
        for k in ("vertices", "joints"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5)
        one = smplx.forward(tm, _t(poses[0]), _t(betas[0]), _t(transl[0]),
                            expression=torch.zeros(0))
        jone = jax.jit(lambda *a: jsmplx.forward(jm, *a, expression=jnp.zeros(0)))(
            poses[0], betas[0], transl[0])
        for k in ("vertices", "joints"):
            np.testing.assert_allclose(one[k].numpy(), np.asarray(jone[k]), atol=1e-5)

    @pytest.mark.parametrize("kind", ["chain", "tree"])
    def test_soc_monitor_vertices(self, kind):
        """The monitor forward in JAX's (3, N, V) order: against JAX's
        soc_monitor_vertices and the port's forward_batch over the flattened
        frames (window betas broadcast), atol 1e-5; motion of 55 joints on
        every rig (the chain rig uses the first 6)."""
        jm, tm = _rig(kind)
        motion = _np(11, 2, 5, 168, scale=0.2)
        m6 = _feats6d(motion)
        betas = _np(12, 2, 300, scale=0.5)
        soc = jsmplx.prepare_soc(jm)
        want = jax.jit(lambda *a: jsmplx.soc_monitor_vertices(jm, soc, *a))(m6, betas)
        got = smplx.soc_monitor_vertices(tm, smplx.prepare_soc(tm), _t(m6), _t(betas))
        assert got.shape == (3, 10, tm.num_vertices)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        nj, nb = tm.num_joints, tm.shapedirs.shape[-1]
        aa = _t(motion[..., :165].reshape(10, 55, 3)[:, :nj].reshape(10, -1))
        fb = _t(np.repeat(betas[:, None, :nb], 5, axis=1).reshape(10, nb))
        ref = smplx.forward_batch(tm, aa, fb, _t(motion[..., 165:].reshape(10, 3)))["vertices"]
        np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref.numpy(), atol=1e-5)

    def test_soc_chunks_frames_and_subsets(self, monkeypatch):
        """Frames are skinned in chunks bounded by _SKIN_CHUNK_ELEMENTS: a bound
        of one frame per chunk gives the same vertices bit for bit. A
        subsampled rig gives the full rig's vertices at its indices."""
        _, tm = _rig("tree")
        m6 = _t(_feats6d(_np(13, 2, 3, 168, scale=0.2)))
        betas, soc = _t(_np(14, 2, 300)), smplx.prepare_soc(tm)
        whole = smplx.soc_monitor_vertices(tm, soc, m6, betas)
        monkeypatch.setattr(smplx, "_SKIN_CHUNK_ELEMENTS", 12 * tm.num_vertices)
        torch.testing.assert_close(smplx.soc_monitor_vertices(tm, soc, m6, betas), whole,
                                   atol=0, rtol=0)
        monkeypatch.undo()
        sub = smplx.subsample_vertices(tm, 20, seed=3)
        idx = np.sort(np.random.default_rng(3).choice(48, size=20, replace=False))
        torch.testing.assert_close(smplx.soc_monitor_vertices(sub, smplx.prepare_soc(sub), m6,
                                                              betas), whole[:, :, idx],
                                   atol=1e-6, rtol=1e-5)

    def test_load_model_matches_jax(self, tmp_path):
        """A published-layout npz (posedirs (V, 3, P), 400 coefficients of which
        300 shape and 100 expression, ``weights``, ``kintree_table``) loads to
        the JAX package's tables, expression block included."""
        rng = np.random.default_rng(4)
        v, j = 30, 55
        np.savez(tmp_path / "SMPLX_NEUTRAL.npz", v_template=rng.normal(size=(v, 3)),
                 shapedirs=rng.normal(size=(v, 3, 400)), posedirs=rng.normal(size=(v, 3, 486)),
                 J_regressor=rng.dirichlet(np.ones(v), size=j),
                 weights=rng.dirichlet(np.ones(j), size=v),
                 kintree_table=np.stack([np.r_[2**32 - 1, jsmplx.SMPLX_PARENTS[1:].astype(int)],
                                         np.arange(j)]))
        got = smplx.load_model(tmp_path / "SMPLX_NEUTRAL.npz", num_betas=300, num_expr=10)
        want = jsmplx.load_model(tmp_path / "SMPLX_NEUTRAL.npz", num_betas=300, num_expr=10)
        assert got.shapedirs.shape == (v, 3, 310) and got.posedirs.shape == (486, 3 * v)
        for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_array_equal(got.parents, want.parents)
        assert got.parents[0] == -1 and got.parents.dtype == np.int32


class TestSmplxInvariants:
    """The structural checks of tests/test_smplx.py, on the port."""

    def _zero(self, m, n: int = 1):
        return torch.zeros(n, m.num_joints * 3), torch.zeros(n, m.shapedirs.shape[-1])

    @pytest.mark.parametrize("betas_seed", [None, 1])
    def test_rest_pose_is_template_plus_shape(self, betas_seed):
        m = smplx.make_test_model()
        poses, betas = self._zero(m)
        if betas_seed is not None:
            betas = _t(_np(betas_seed, 1, 8))
        out = smplx.forward_batch(m, poses, betas, torch.zeros(1, 3))
        want = m.v_template + torch.einsum("vck,k->vc", m.shapedirs, betas[0])
        torch.testing.assert_close(out["vertices"][0], want, atol=1e-5, rtol=0)
        if betas_seed is None:
            torch.testing.assert_close(out["joints"][0], m.j_regressor @ m.v_template,
                                       atol=1e-5, rtol=0)

    def test_translation_equivariance(self):
        m = smplx.make_test_model()
        poses, betas = _t(_np(2, 1, m.num_joints * 3, scale=0.3)), torch.zeros(1, 8)
        t = torch.tensor([[1.0, -2.0, 0.5]])
        a = smplx.forward_batch(m, poses, betas, torch.zeros(1, 3))["vertices"]
        b = smplx.forward_batch(m, poses, betas, t)["vertices"]
        torch.testing.assert_close(b, a + t[:, None], atol=1e-5, rtol=0)

    def test_global_orient_is_rigid_rotation_about_root(self):
        m = smplx.make_test_model()._replace(posedirs=torch.zeros(45, 192))
        poses, betas = self._zero(m)
        poses[0, :3] = torch.tensor([0.0, 0.0, np.pi / 2])
        out = smplx.forward_batch(m, poses, betas, torch.zeros(1, 3))["vertices"][0]
        root = (m.j_regressor @ m.v_template)[0]
        rot = axis_angle_to_matrix(poses[0, :3])
        torch.testing.assert_close(out, (m.v_template - root) @ rot.T + root, atol=1e-4, rtol=0)

    @pytest.mark.parametrize("joint", ["last", "middle"])
    def test_articulation_moves_descendants_rigidly(self, joint):
        """Rotating a joint leaves its ancestors (and itself) in place, moves
        its descendants, and keeps the chain's bone lengths."""
        m = smplx.make_test_model()._replace(posedirs=torch.zeros(45, 192))
        k = m.num_joints - 1 if joint == "last" else m.num_joints // 2
        poses, betas = self._zero(m)
        poses[0, 3 * k: 3 * k + 3] = torch.tensor([0.5, 0.2, 1.2])
        joints = smplx.forward_batch(m, poses, betas, torch.zeros(1, 3))["joints"][0]
        rest = m.j_regressor @ m.v_template
        torch.testing.assert_close(joints[: k + 1], rest[: k + 1], atol=1e-5, rtol=0)
        if joint == "middle":
            assert (joints[k + 1:] - rest[k + 1:]).abs().max() > 1e-3
        torch.testing.assert_close(torch.diff(joints, dim=0).norm(dim=1),
                                   torch.diff(rest, dim=0).norm(dim=1), atol=1e-5, rtol=0)

    def test_shapes_and_grad_flows_through_poses(self):
        m = smplx.make_test_model()
        poses = torch.full((4, m.num_joints * 3), 0.1, requires_grad=True)
        out = smplx.forward_batch(m, poses, _t(_np(3, 4, 8)), _t(_np(4, 4, 3)))
        assert out["vertices"].shape == (4, 64, 3) and out["joints"].shape == (4, 6, 3)
        (out["vertices"] ** 2).sum().backward()
        assert torch.isfinite(poses.grad).all() and poses.grad.abs().sum() > 0

    def test_subsample_is_exact_and_deterministic(self):
        """Subset vertices equal the full model's at the subset's indices, the
        joints are unchanged, the folded regressor equals the regressor path,
        and the subset follows the seed."""
        m = smplx.make_test_model(num_vertices=64)
        sub = smplx.subsample_vertices(m, 16, seed=3)
        args = (_t(_np(1, 2, 18, scale=0.3)), _t(_np(2, 2, 8)), _t(_np(3, 2, 3, scale=0.1)))
        full, part = smplx.forward_batch(m, *args), smplx.forward_batch(sub, *args)
        idx = np.sort(np.random.default_rng(3).choice(64, size=16, replace=False))
        torch.testing.assert_close(part["vertices"], full["vertices"][:, idx], atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(part["joints"], full["joints"], atol=1e-6, rtol=1e-5)
        assert smplx.subsample_vertices(m, 64) is m
        folded = m._replace(j_template=m.j_regressor @ m.v_template,
                            j_shapedirs=torch.einsum("jv,vck->jck", m.j_regressor, m.shapedirs))
        torch.testing.assert_close(smplx.forward_batch(folded, *args)["vertices"],
                                   full["vertices"], atol=1e-6, rtol=1e-5)
        assert torch.equal(smplx.subsample_vertices(m, 16, seed=3).v_template, sub.v_template)

    @staticmethod
    def _fk_naive(rot, joints, parents):
        j = joints.shape[0]
        rel_j = joints.astype(np.float64).copy()
        for i in range(1, j):
            if parents[i] >= 0:
                rel_j[i] = joints[i] - joints[parents[i]]
        world = []
        for i in range(j):
            local = np.eye(4)
            local[:3, :3], local[:3, 3] = rot[i], rel_j[i]
            world.append(local if parents[i] < 0 else world[parents[i]] @ local)
        world = np.stack(world)
        rel = world.copy()
        rel[:, :3, 3] -= np.einsum("jab,jb->ja", world[:, :3, :3], joints)
        return world[:, :3, 3], rel

    @pytest.mark.parametrize("tree", ["smplx", "chain"])
    def test_level_scheduled_fk_matches_naive(self, tree):
        """Batched over frames, on the branched SMPL-X tree and a chain: atol
        3e-5 against sequential float64 composition."""
        parents = jsmplx.SMPLX_PARENTS if tree == "smplx" else np.arange(-1, 5, dtype=np.int32)
        j = len(parents)
        aa, joints = _np(7, 2, j, 3, scale=0.4), _np(8, j, 3)
        rot = axis_angle_to_matrix(_t(aa))
        pj, rel = smplx._rigid_transforms(rot, _t(joints).expand(2, j, 3), parents)
        for f in range(2):
            pj_ref, rel_ref = self._fk_naive(rot[f].double().numpy(), joints, parents)
            np.testing.assert_allclose(pj[f].numpy(), pj_ref, atol=3e-5)
            np.testing.assert_allclose(rel[f].numpy(), rel_ref, atol=3e-5)
        jpj, jrel = jax.jit(lambda r, jt: jsmplx._rigid_transforms(r, jt, parents))(
            j_aa_to_matrix(jnp.asarray(aa[0])), joints)
        np.testing.assert_allclose(rel[0].numpy(), np.asarray(jrel), atol=1e-5)
        with pytest.raises(ValueError, match="topologically"):
            smplx._fk_schedule((-1, 2, 0))

    def test_smplx_tree_branches_are_isolated(self):
        """Rotating the right wrist (joint 21) moves the right fingers and
        leaves the left hand's joints in place."""
        m = smplx.make_test_model(num_vertices=32, num_joints=55, num_betas=8,
                                  parents=smplx.SMPLX_PARENTS)._replace(
                                      posedirs=torch.zeros(486, 96))
        poses, betas = self._zero(m)
        rest = smplx.forward_batch(m, poses, betas, torch.zeros(1, 3))["joints"][0]
        poses[0, 21 * 3: 22 * 3] = torch.tensor([0.0, 0.8, 0.0])
        posed = smplx.forward_batch(m, poses, betas, torch.zeros(1, 3))["joints"][0]
        torch.testing.assert_close(posed[25:40], rest[25:40], atol=1e-5, rtol=0)
        assert (posed[40:55] - rest[40:55]).abs().max() > 1e-3


# ------------------------------------------------------- losses, add_noise

class TestLossesAndNoising:
    def test_add_noise_matches_jax(self):
        """float32, atol 1e-6; (B,) timesteps across the whole schedule."""
        x, eps = _np(1, 4, 1, 16), _np(2, 4, 1, 16)
        t = np.array([0, 1, 500, 999])
        want = jadd_noise(jmake_schedule(), jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
        got = add_noise(make_schedule(), _t(x), _t(eps), _t(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    def test_smooth_l1_against_torch_and_jax(self):
        x = _np(3, 5, 7, scale=2.0)
        want = torch.nn.SmoothL1Loss()(_t(x), torch.zeros(5, 7))
        assert L.smooth_l1(_t(x), torch.zeros(5, 7)).item() == pytest.approx(want.item(),
                                                                            rel=1e-6)
        assert float(jL.smooth_l1(jnp.asarray(x), jnp.zeros((5, 7)))) == pytest.approx(
            want.item(), rel=1e-6)
        assert L.smooth_l1(torch.tensor([0.0, 0.5, 1.0, 2.0, -3.0]),
                           torch.zeros(5)).item() == pytest.approx(0.925, rel=1e-6)

    @pytest.mark.parametrize("monitors", ["none", "gen", "all"])
    def test_lpdm_losses_match_jax(self, monitors):
        """Every term and the total, rtol 1e-6; a perfect reconstruction with
        zero KL and a perfect epsilon gives 0 (tests/test_train_steps.py)."""
        m, r, mu, lv, n, npred, g = (_np(i, 2, 4, 6, scale=0.5) for i in range(7))
        va, vb, vc = (_np(10 + i, 3, 8, 5) for i in range(3))
        kw = {"none": {}, "gen": {"gen_m_rst": g},
              "all": {"gen_m_rst": g, "rec_vertices": (va, vb), "gen_vertices": (vc, vb)}}
        args = [m, r, mu, lv, n, npred]
        _, want = jL.lpdm_losses(*map(jnp.asarray, args), **{
            k: jax.tree.map(jnp.asarray, v) for k, v in kw[monitors].items()})
        _, got = L.lpdm_losses(*map(_t, args), **{
            k: jax.tree.map(_t, v) for k, v in kw[monitors].items()})
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].item() == pytest.approx(float(want[k]), rel=1e-6), k
        ones = torch.ones(2, 4, 6)
        total, logs = L.lpdm_losses(ones, ones, torch.zeros(2, 1, 3), torch.zeros(2, 1, 3),
                                    torch.ones(2, 1, 3), torch.ones(2, 1, 3))
        assert total.item() == 0.0
        assert set(logs) == {"recons_feature", "kl_motion", "inst_loss", "total"}


# ------------------------------------------------------------- the step

def _batch(seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    return {"motion": (0.1 * rng.normal(size=(b, T, 168))).astype(np.float32),
            "con": rng.normal(size=(b, COND)).astype(np.float32),
            "emo": rng.normal(size=(b, COND)).astype(np.float32),
            "sty": rng.normal(size=(b, COND)).astype(np.float32),
            "betas": (0.5 * rng.normal(size=(b, N_BETAS))).astype(np.float32)}


def _draws(seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    shape = (b, 1, 16)
    return {"enc": rng.normal(size=shape).astype(np.float32),
            "enc2": rng.normal(size=shape).astype(np.float32),
            "t": rng.integers(0, 1000, b).astype(np.int64),
            "noise": rng.normal(size=shape).astype(np.float32),
            "latents": rng.normal(size=shape).astype(np.float32)}


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _port_noise(draws):
    return tg.StepNoise(*(_t(draws[k]) for k in tg.StepNoise._fields))


def _jax_lpdm_value_and_grad(jm):
    """jitted value_and_grad of the JAX step's loss (amuse_tpu/train/gesture.py:
    126-205) composed with the draws injected and dropout off."""
    prior = jvae.MotionPrior(jvae.PriorConfig(**PRIOR_KW))
    den = jden.Denoiser(jden.DenoiserConfig(**DEN_KW))
    sched, soc = jmake_schedule(), jsmplx.prepare_soc(jm)

    def loss(params, batch, draws):
        m6 = jmotion.featurize(batch["motion"], "6D", False)
        pp = {"params": params["prior"]}
        mu, logvar = prior.apply(pp, m6, method="encode_params")
        m_rst = prior.apply(pp, mu + jnp.exp(0.5 * logvar) * draws["enc"], T, method="decode")
        mu2, lv2 = prior.apply(pp, m6, method="encode_params")
        z_sg = jax.lax.stop_gradient(mu2 + jnp.exp(0.5 * lv2) * draws["enc2"])
        conds = (batch["con"], batch["emo"], batch["sty"])
        noise_pred = den.apply({"params": params["denoiser"]},
                               jadd_noise(sched, z_sg, draws["noise"], draws["t"]),
                               draws["t"], *conds)
        sg = jax.lax.stop_gradient(params)
        gen_z = jddim_sample(sched, lambda x, t: den.apply({"params": sg["denoiser"]}, x, t,
                                                           *conds),
                             None, draws["latents"].shape, STEPS,
                             initial_latents=draws["latents"])
        gen_m = prior.apply({"params": sg["prior"]}, gen_z, T, method="decode")

        # the three vertex forwards as one call over the stacked windows (one
        # program to compile; each window's vertices are its own)
        v_ref, v_rst, v_gen = jnp.split(jsmplx.soc_monitor_vertices(
            jm, soc, jnp.concatenate([m6, jax.lax.stop_gradient(m_rst), gen_m]),
            jnp.tile(batch["betas"], (3, 1))), 3, axis=1)
        return jL.lpdm_losses(m6, m_rst, mu, logvar, draws["noise"], noise_pred, gen_m,
                              (v_rst, v_ref), (v_gen, v_ref))

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def lpdm():
    """JAX parameters (the port's initialisation from seed 0, through the JAX
    package's importer), the jitted value_and_grad, and the port's rig."""
    jm, tm = _rig("tree")
    state = tg.init_state(0, PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW), device=CPU)
    sd = {k: {n: v.numpy() for n, v in m.state_dict().items()}
          for k, m in (("prior", state.prior), ("denoiser", state.denoiser))}
    params = {"prior": ti.motion_prior_from_torch(sd["prior"], num_layers=3),
              "denoiser": ti.denoiser_from_torch(sd["denoiser"], num_layers=3)}
    return params, _jax_lpdm_value_and_grad(jm), tm


TCFG = tg.GestureTrainConfig(learning_rate=LR, num_inference_steps=STEPS)


def _port_state(params, dropout: float = 0.0) -> tg.GestureTrainState:
    state = tg.init_state(0, PriorConfig(**PRIOR_KW, dropout=dropout),
                          DenoiserConfig(**DEN_KW, dropout=dropout), TCFG, CPU)
    state.prior.load_state_dict(convert.prior_from_jax(jax.tree.map(np.asarray,
                                                                    params["prior"])))
    state.denoiser.load_state_dict(convert.denoiser_from_jax(jax.tree.map(np.asarray,
                                                                          params["denoiser"])))
    return state


def _port_tree(tree) -> dict:
    """A JAX {prior, denoiser} tree as the port's parameter names."""
    tree = jax.tree.map(np.asarray, tree)
    return {**{f"prior.{k}": v for k, v in convert.prior_from_jax(tree["prior"]).items()},
            **{f"denoiser.{k}": v for k, v in convert.denoiser_from_jax(tree["denoiser"]).items()}}


def _named(state) -> dict:
    return {**{f"prior.{k}": v for k, v in state.prior.named_parameters()},
            **{f"denoiser.{k}": v for k, v in state.denoiser.named_parameters()}}


def _port_loss(state, batch, draws, tm, with_monitor=True):
    return tg.loss_fn(state, _port_batch(batch), TCFG, make_schedule(), _port_noise(draws),
                      None, with_monitor, tm, smplx.prepare_soc(tm) if with_monitor else None)


class TestTrainStep:
    def test_loss_and_every_gradient_match_jax(self, lpdm):
        """The whole step (VAE pass, re-encode, noising, epsilon prediction, the
        3-step DDIM monitor, decode, three vertex forwards on a 55-joint SMPL-X
        tree rig, lpdm_losses): total rtol 1e-5, every term rtol 1e-5 (atol
        1e-7); each parameter's gradient within 1e-4 of its largest entry."""
        params, value_and_grad, tm = lpdm
        batch, draws = _batch(1), _draws(2)
        (jtotal, jlogs), jgrads = value_and_grad(params, batch, draws)
        state = _port_state(params)
        total, logs = _port_loss(state, batch, draws, tm)
        total.backward()
        assert total.item() == pytest.approx(float(jtotal), rel=1e-5)
        assert logs.keys() == jlogs.keys() and "gen_vtex_displacement" in logs
        for k in jlogs:
            assert logs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-5, abs=1e-7), k
        want = _port_tree(jgrads)
        named = _named(state)
        assert named.keys() == want.keys()
        for n, p in named.items():
            top = float(np.abs(want[n].numpy()).max())
            got = torch.zeros_like(p) if p.grad is None else p.grad
            err = (got - want[n]).abs().max().item()
            assert err <= 1e-4 * top + 1e-9, (n, err, top)

    def test_two_adamw_steps_match_fused_adam(self, lpdm):
        """Parameters after two steps against JAX FusedAdam mode "decoupled"
        (weight decay 0.01, lr 1e-4): atol lr/10 on every element whose
        gradient is well above Adam's eps in both steps (|g| > 1e-5); where a
        gradient is zero in exact arithmetic, rounding noise sets the sign of
        a +-lr update."""
        params, value_and_grad, tm = lpdm
        batch, draws = _batch(3), _draws(4)
        opt = make_fused_adam(weight_decay=0.01, mode="decoupled")
        apply = jax.jit(opt.apply)
        jstate, jparams, jgrads = opt.init(params, LR), params, []
        for _ in range(2):
            _, g = value_and_grad(jparams, batch, draws)
            jgrads.append(_port_tree(g))
            jparams, jstate = apply(jstate, jparams, g)
        state = _port_state(params)
        step = tg.make_train_step(PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW), TCFG, tm)
        for _ in range(2):
            logs = step(state, _port_batch(batch), None, stochastic=False,
                        noise=_port_noise(draws))
        assert state.step == 2 and torch.isfinite(logs["total"])
        assert isinstance(state.optimizer, torch.optim.AdamW)
        assert state.optimizer.param_groups[0]["weight_decay"] == 0.01
        want, moved = _port_tree(jparams), 0
        for n, p in _named(state).items():
            keep = (jgrads[0][n].abs() > 1e-5) & (jgrads[1][n].abs() > 1e-5)
            diff = (p.detach() - want[n]).abs()[keep]
            assert diff.numel() == 0 or diff.max().item() <= LR / 10, n
            moved += int(keep.sum())
        assert moved > 0.5 * sum(p.numel() for p in _named(state).values())

    def test_monitor_terms_carry_no_gradient(self, lpdm):
        """With and without the monitor: the same gradients bit for bit, and
        totals that differ by exactly the three monitor terms."""
        params, _, tm = lpdm
        batch, draws = _batch(5), _draws(6)
        out = {}
        for mon in (True, False):
            state = _port_state(params)
            total, logs = _port_loss(state, batch, draws, tm, with_monitor=mon)
            total.backward()
            out[mon] = (logs, {n: p.grad.clone() for n, p in _named(state).items()
                               if p.grad is not None})
        (lm, gm), (lf, gf) = out[True], out[False]
        assert gm.keys() == gf.keys()
        for n in gm:
            assert torch.equal(gm[n], gf[n]), n
        extra = sum(lm[k] for k in ("gen_feature", "rec_vtex_displacement",
                                    "gen_vtex_displacement"))
        assert lm["total"].item() == pytest.approx((lf["total"] + extra).item(), rel=1e-6)
        assert "gen_feature" not in lf

    def test_dropout_fires_and_the_step_replays_from_its_seed(self, lpdm):
        """Dropout 0.1: the same (seed, epoch, step) gives the same loss,
        another step another, dropout off a third; the monitor leaves both
        modules in training mode."""
        params, _, tm = lpdm
        batch = _port_batch(_batch(7))
        sched, soc = make_schedule(), smplx.prepare_soc(tm)
        totals = []
        for step_idx, train in ((0, True), (0, True), (1, True), (0, False)):
            state = _port_state(params, dropout=0.1)
            state.prior.train(train)
            state.denoiser.train(train)
            gen = step_generator(7, 1, step_idx, CPU)
            noise = tg.draw_step_noise(step_generator(7, 1, 0, CPU), B, state.prior.cfg, sched,
                                       CPU)
            totals.append(tg.loss_fn(state, batch, TCFG, sched, noise, gen, True, tm,
                                     soc)[0].item())
            assert state.prior.training == train and state.denoiser.training == train
        assert totals[0] == totals[1]
        assert len({totals[0], totals[2], totals[3]}) == 3

    def test_to_feats6d(self):
        """'3D' features (with and without translation) -> the 6D features of
        the same motion; '6D' passes through."""
        motion = _t(_np(9, 2, 4, 168, scale=0.3))
        m6 = tg.to_feats6d(motion, "3D", False)
        np.testing.assert_allclose(m6.numpy(), _feats6d(motion.numpy()), atol=1e-6)
        no_trans = tg.to_feats6d(motion[..., :165], "3D", True)
        torch.testing.assert_close(no_trans[..., :330], m6[..., :330])
        assert no_trans[..., 330:].abs().max() == 0
        assert tg.to_feats6d(m6, "6D", False) is m6


class TestDecoderDropout:
    """The decoder layer's dropout (new in the port with this slice), as
    tests/test_torch_port_train.py::TestDropout holds the encoder layer's."""

    D, H, FF = 16, 2, 32

    def _layer(self, p):
        layer = ttr.DecoderLayer(self.D, self.H, self.FF, dropout=p)
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for prm in layer.parameters():
                prm.copy_(_t(rng.normal(scale=0.2, size=prm.shape).astype(np.float32)))
        return layer

    @pytest.mark.parametrize("training", [False, True])
    def test_without_dropout_matches_jax(self, training):
        """Dropout 0.1 in eval mode, or 0 in training mode, is the
        deterministic JAX layer: atol 1e-5 (float32)."""
        layer = self._layer(0.0 if training else 0.1).train(training)
        p = ti.decoder_layer_from_torch(
            {f"l.{k}": v.numpy() for k, v in layer.state_dict().items()}, "l")
        tgt, mem = _np(1, 2, 6, self.D), _np(2, 2, 1, self.D)
        ref = jtr.DecoderLayer(self.D, self.H, self.FF, 0.1).apply({"params": p}, tgt, mem)
        mine = layer(_t(tgt), _t(mem), generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), atol=1e-5)

    def test_train_mode_draws_from_the_generator(self):
        layer = self._layer(0.1).train()
        tgt, mem = _t(_np(3, 2, 6, self.D)), _t(_np(4, 2, 1, self.D))
        def run(seed):
            return layer(tgt, mem, generator=torch.Generator().manual_seed(seed))
        torch.testing.assert_close(run(3), run(3), atol=0, rtol=0)
        assert not torch.allclose(run(3), run(4))
        assert not torch.allclose(run(3), layer.eval()(tgt, mem))


# ------------------------------------------------------------- prefetch

class TestPrefetch:
    """The cases of tests/test_prefetch.py, on the port (CPU tensors)."""

    def test_order_and_values_match_jax(self):
        batches = [{"x": np.full((4,), i, np.float32), "y": np.arange(i, i + 2)}
                   for i in range(10)]
        got = list(prefetch_to_device(iter(batches), size=3, device="cpu"))
        want = list(jprefetch(iter(batches), size=3))
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            for k in w:
                assert isinstance(g[k], torch.Tensor) and g[k].device == CPU
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))

    def test_errors_reach_the_consumer(self):
        def gen():
            yield {"x": np.zeros(2)}
            raise RuntimeError("boom")

        it = prefetch_to_device(gen(), size=2, device="cpu")
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            list(it)

    def test_producer_exits_when_consumer_abandons(self):
        before = threading.active_count()
        gen = prefetch_to_device(({"x": np.full((4,), i)} for i in range(100)), size=2,
                                 device="cpu")
        next(gen)
        gen.close()
        deadline = time.time() + 5.0
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before, "producer thread leaked"


# ------------------------------------------------------------- satellites

def test_gelu_tanh_knob_matches_jax():
    """audio.gelu_tanh: the port's ASTEncoder with the tanh GELU against the
    JAX one with the knob on, same weights (atol 1e-5), and apart from the
    exact-erf encoder (tests/test_full_dims_import.py for JAX)."""
    kw = dict(input_tdim=64, input_fdim=32, embed_dim=16, depth=1, num_heads=2, feature_dim=12)
    x = _np(1, 2, 64, 32)
    torch.manual_seed(0)
    sd = tast.ASTEncoder(tast.ASTConfig(**kw)).state_dict()
    params = ti.ast_encoder_from_torch({f"e.{k}": v.numpy() for k, v in sd.items()}, "e",
                                       depth=1)
    want = jax.jit(jast.ASTEncoder(jast.ASTConfig(gelu_tanh=True, **kw)).apply)(
        {"params": params}, jnp.asarray(x))["feature"]
    feats = {}
    for knob in (True, False):
        enc = tast.ASTEncoder(tast.ASTConfig(gelu_tanh=knob, **kw)).eval()
        enc.load_state_dict(sd)
        with torch.no_grad():
            feats[knob] = enc(_t(x))["feature"]
    np.testing.assert_allclose(feats[True].numpy(), np.asarray(want), atol=1e-5)
    assert (feats[True] - feats[False]).abs().max() > 1e-7


def test_run_logger_without_wandb(tmp_path, monkeypatch):
    """JSONL records always; wandb only with WANDB_API_KEY set and the module
    importable (it is not installed here: the logger carries on without it)."""
    monkeypatch.setenv("WANDB_API_KEY", "unused")
    logger = RunLogger(tmp_path)
    logger.log(3, {"a": 1.5})
    assert logger._wandb is None
    (rec,) = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert rec["step"] == 3 and rec["a"] == 1.5
    RunLogger(None).log(0, {"a": 1.0})


# ------------------------------------------------------------------ CLI

TINY = {"audio": {"ast_embed_dim": 16, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12},
        "gesture": {"latent_dim": 16, "ff_size": 32, "num_layers": 3, "num_heads": 2,
                    "cond_dim": 12, "num_inference_steps": 3, "epochs": 1, "batch_size": 4,
                    "model_save_freq": 1, "vtex_subsample": 16},
        "dtype": "float32"}


def _write_smplx_npz(path):
    """A rig of 40 vertices on the 55-joint SMPL-X tree in the published npz
    layout (posedirs (V, 3, P), ``weights``, ``kintree_table``)."""
    m = jsmplx.make_test_model(num_vertices=40, num_joints=55, num_betas=10,
                               parents=jsmplx.SMPLX_PARENTS)
    v = m.num_vertices
    np.savez(path, v_template=np.asarray(m.v_template), shapedirs=np.asarray(m.shapedirs),
             posedirs=np.asarray(m.posedirs).T.reshape(v, 3, -1),
             J_regressor=np.asarray(m.j_regressor), weights=np.asarray(m.lbs_weights),
             kintree_table=np.stack([m.parents, np.arange(55)]))


@pytest.fixture(scope="module")
def beat_cache(tmp_path_factory):
    """A synthetic BEAT tree (2 actors x 1 take x 4 windows), its stage-2 cache
    built by the port's prepare_data, and an SMPL-X npz."""
    root = tmp_path_factory.mktemp("lpdm_cli")
    rng = np.random.default_rng(0)
    write_take(root, 2, "scott", "0_9_9", 4, rng)
    write_take(root, 9, "miranda", "0_9_9", 4, rng)
    (root / "smplx").mkdir()
    _write_smplx_npz(root / "smplx" / "SMPLX_NEUTRAL.npz")
    cfg = _cfg(root, root / "prep", {})
    cli.main(["--fn", "prepare_data", "--cfg", cfg, "--device", "cpu"])
    return root


def _cfg(root, work, gesture: dict) -> str:
    work.mkdir(parents=True, exist_ok=True)
    cfg = {**TINY, "out_dir": str(work / "runs"),
           "gesture": {**TINY["gesture"], **gesture},
           "data": {"data_root": str(root / "beat"), "mosh_root": str(root / "mosh"),
                    "cache_dir": str(root / "cache"), "stage1_dataset": str(work / "s1.npz"),
                    "smplx_model_dir": str(root / "smplx")}}
    (work / "cfg.json").write_text(json.dumps(cfg))
    return str(work / "cfg.json")


def _train(root, work, epochs: int, resume: str = "") -> tuple:
    argv = ["--fn", "train_gesture", "--cfg", _cfg(root, work, {"epochs": epochs}),
            "--device", "cpu"]
    cli.main(argv + (["--set", f"resume={resume}"] if resume else []))
    run = sorted((work / "runs").iterdir())[-1]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return run, {r["step"]: r for r in rows}


class TestCli:
    def test_train_gesture_checkpoint_resume_and_infer(self, beat_cache, tmp_path,
                                                       monkeypatch, capsys):
        """Two epochs of 2 steps with the DDIM and vertex monitors (SMPL-X npz
        found, subsampled to 16 vertices): finite losses and a checkpoint per
        epoch; a run killed after epoch 1 and resumed logs the unkilled run's
        epoch-2 losses (rtol 1e-6); the run directory loads through
        ``AMUSE_TPU_CKPT`` into ``infer_gesture`` and ``edit_gesture``."""
        full, rows = _train(beat_cache, tmp_path / "full", 2)
        out = capsys.readouterr().out
        assert "vertex monitor subsampled to 16 vertices" in out and "epoch 2/2" in out
        assert sorted(rows) == [0, 1]
        for k in ("train_total", "train_gen_feature", "train_rec_vtex_displacement",
                  "train_gen_vtex_displacement"):
            assert np.isfinite(rows[1][k]), k
        mgr = CheckpointManager(full / "checkpoints")
        assert mgr.steps() == [1, 2]
        state, meta = mgr.restore()
        assert state["step"] == 4 and meta["step"] == 2  # 2 steps of 4 windows per epoch
        assert set(state["params"]) == {"prior", "denoiser"}

        part, _ = _train(beat_cache, tmp_path / "part", 1)
        capsys.readouterr()
        _, resumed = _train(beat_cache, tmp_path / "resumed", 2, str(part / "checkpoints"))
        out = capsys.readouterr().out
        assert "resumed full train state" in out and "at epoch 1" in out
        assert sorted(resumed) == [1]
        for k, v in rows[1].items():
            if k.startswith("train_"):
                assert resumed[1][k] == pytest.approx(v, rel=1e-6), k

        ast = tast.ASTDisentangler(tast.ASTConfig(embed_dim=16, depth=1, num_heads=2,
                                                  feature_dim=12))
        CheckpointManager(tmp_path / "ast").save(1, {"model": ast.state_dict()})
        monkeypatch.setenv("AMUSE_TPU_CKPT", str(full / "checkpoints"))
        monkeypatch.setenv("AMUSE_TPU_AST_CKPT", str(tmp_path / "ast"))
        params = cio.load_pipeline_params()
        for kind in ("prior", "denoiser"):
            for k, v in state["params"][kind].items():
                assert torch.equal(params._asdict()[kind][k], v), k
        cfg = _cfg(beat_cache, tmp_path / "infer", {})
        monkeypatch.chdir(tmp_path)
        write_take(tmp_path / "viz_dump" / "test", 2, "scott", "0_9_9", 1,
                   np.random.default_rng(1), motion=False)
        demo = tmp_path / "viz_dump" / "test" / "e_speech"
        demo.mkdir(parents=True)
        for i, wav in enumerate(sorted((tmp_path / "viz_dump" / "test" / "beat" / "2")
                                       .glob("*.wav"))[:1] * 2):
            (demo / f"{i}_{wav.name}").write_bytes(wav.read_bytes())
        capsys.readouterr()
        cli.main(["--fn", "infer_gesture", "--cfg", cfg, "--device", "cpu",
                  "--wav-dir", str(tmp_path / "viz_dump" / "test" / "beat" / "2")])
        cli.main(["--fn", "edit_gesture", "--cfg", cfg, "--device", "cpu"])
        out = capsys.readouterr().out
        assert "random weights" not in out and "demo emotion swap" in out
        runs = tmp_path / "infer" / "runs"
        files = sorted(runs.glob("*/gesture/*/rep0/seq_*/*.npz"))
        assert files and np.load(files[0])["poses"].shape == (300, 55, 3)
        assert sorted(runs.glob("*/e_gesture/rep0/emotion_swapped/seq_*/*.npz"))

    def test_refusals_and_clamp(self, beat_cache, tmp_path, capsys, monkeypatch):
        """The native ABIN loader whose build fails raises (no fallback to the
        Python cache); a batch above the cache's 8 windows is clamped to it;
        without a card the default device raises."""
        from amuse_tpu_torch.native import loader

        (tmp_path / "broken.cc").write_text("not C++\n")
        monkeypatch.setattr(loader, "SRC", tmp_path / "broken.cc")
        cfg = _cfg(beat_cache, tmp_path / "n", {"native_loader": True})
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            cli.main(["--fn", "train_gesture", "--cfg", cfg, "--device", "cpu"])
        monkeypatch.undo()
        cfg = _cfg(beat_cache, tmp_path / "c", {"batch_size": 32, "vtex_displacement": False,
                                                "monitor_every": 2})
        cli.main(["--fn", "train_gesture", "--cfg", cfg, "--device", "cpu"])
        out = capsys.readouterr().out
        assert "batch 32 > cache 8; clamped to 8" in out and "epoch 1/1" in out
        assert "gen_feature" in out  # step 0 of the epoch is a monitored one
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                cli.main(["--fn", "train_gesture", "--cfg", cfg])
