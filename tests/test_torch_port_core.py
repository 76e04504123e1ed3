"""The PyTorch port's core, audio and scheduler modules against the JAX package
and the committed goldens (CPU, float32).

Inputs are made with numpy from a seed and fed to both packages.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.audio import fbank as jfb
from amuse_tpu.core import motion as jmotion
from amuse_tpu.core import rotations as jrot
from amuse_tpu.diffusion import schedulers as jsched
from amuse_tpu_torch.audio import fbank as tfb
from amuse_tpu_torch.audio import wavio as twavio
from amuse_tpu_torch.core import motion as tmotion
from amuse_tpu_torch.core import rotations as trot
from amuse_tpu_torch.diffusion import schedulers as tsched
from tests.goldens.make_scheduler_golden import SCHED_KW, eps_net_weights

GOLDENS = Path(__file__).parent / "goldens"
REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _aa(seed, n=64, scale=1.0):
    return np.random.default_rng(seed).normal(scale=scale, size=(n, 3)).astype(np.float32)


class TestRotations:
    # float32 trig and Gram-Schmidt in two frameworks: rounding-level agreement
    ATOL = 1e-5

    @pytest.mark.parametrize("fn", ["axis_angle_to_quaternion", "axis_angle_to_matrix",
                                    "axis_angle_to_rotation_6d"])
    def test_from_axis_angle_matches_jax(self, fn):
        aa = _aa(0)
        aa[:4] *= 1e-8  # the small-angle Taylor branch
        ref = np.asarray(getattr(jrot, fn)(jnp.asarray(aa)))
        np.testing.assert_allclose(getattr(trot, fn)(_t(aa)).numpy(), ref, atol=self.ATOL)

    def test_6d_and_quaternion_to_matrix_match_jax(self):
        rng = np.random.default_rng(1)
        d6 = rng.normal(size=(64, 6)).astype(np.float32)
        np.testing.assert_allclose(trot.rotation_6d_to_matrix(_t(d6)).numpy(),
                                   np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6))),
                                   atol=self.ATOL)
        quat = rng.normal(size=(64, 4)).astype(np.float32)
        np.testing.assert_allclose(trot.quaternion_to_matrix(_t(quat)).numpy(),
                                   np.asarray(jrot.quaternion_to_matrix(jnp.asarray(quat))),
                                   atol=self.ATOL)
        slabs = trot.rotation_6d_to_matrix_slabs(tuple(_t(d6[:, i]) for i in range(6)))
        np.testing.assert_allclose(torch.stack(slabs, -1).reshape(64, 3, 3).numpy(),
                                   trot.rotation_6d_to_matrix(_t(d6)).numpy(), atol=1e-6)

    def test_matrix_to_axis_angle_matches_jax_as_rotations(self):
        """matrix_to_quaternion picks its branch by argmax: near ties and near
        angle pi the two frameworks may pick different but equivalent
        quaternions, so the axis-angle results are compared as the rotation
        matrices they give (atol 1e-5), plus directly away from pi."""
        aa = _aa(2, scale=0.8)
        m = trot.axis_angle_to_matrix(_t(aa))
        mine = trot.matrix_to_axis_angle(m)
        ref = np.asarray(jrot.matrix_to_axis_angle(jnp.asarray(m.numpy())))
        np.testing.assert_allclose(trot.axis_angle_to_matrix(mine).numpy(),
                                   np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(ref))),
                                   atol=self.ATOL)
        angles = np.linalg.norm(aa, axis=-1)
        away = angles < 2.5
        np.testing.assert_allclose(mine.numpy()[away], ref[away], atol=1e-4)
        quat = trot.matrix_to_quaternion(m)
        assert (quat[..., 0] >= 0).all()

    def test_d6_golden(self):
        d = np.load(GOLDENS / "golden_v1.npz")
        np.testing.assert_allclose(trot.axis_angle_to_rotation_6d(_t(d["aa"])).numpy(),
                                   d["d6"], atol=1e-6)

    def test_round_trip(self):
        aa = _aa(3, scale=0.5)
        back = trot.rotation_6d_to_axis_angle(trot.axis_angle_to_rotation_6d(_t(aa)))
        np.testing.assert_allclose(back.numpy(), aa, atol=1e-5)


class TestMotion:
    def _motion(self, seed=4):
        return (0.3 * np.random.default_rng(seed).normal(size=(2, 10, 168))).astype(np.float32)

    def test_featurize_defeaturize_match_jax(self):
        m = self._motion()
        for rep, skip in (("6D", False), ("3D", False), ("3D", True)):
            mine = tmotion.featurize(_t(m), rep, skip).numpy()
            ref = np.asarray(jmotion.featurize(jnp.asarray(m), rep, skip))
            np.testing.assert_allclose(mine, ref, atol=1e-5)
            poses, trans = tmotion.defeaturize(_t(mine), rep, skip)
            jposes, jtrans = jmotion.defeaturize(jnp.asarray(ref), rep, skip)
            np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-4)
            np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), atol=1e-6)
        with pytest.raises(ValueError):
            tmotion.featurize(_t(m), "6D", True)

    def test_zero_jaw_and_window_motion(self):
        poses = np.random.default_rng(5).normal(size=(3, 300, 55, 3)).astype(np.float32)
        src = _t(poses)
        out = tmotion.zero_jaw(src)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jmotion.zero_jaw(poses)))
        assert src.abs()[..., 22, :].sum() > 0  # input untouched
        seq = np.arange(1000 * 4, dtype=np.float32).reshape(1000, 4)
        np.testing.assert_array_equal(tmotion.window_motion(_t(seq)).numpy(),
                                      np.asarray(jmotion.window_motion(jnp.asarray(seq))))


class TestFbank:
    def test_matches_jax(self):
        wave = np.random.default_rng(6).normal(scale=0.1, size=(2, 160000)).astype(np.float32)
        mine = tfb.wav_chunk_to_fbank(_t(wave)).numpy()
        ref = np.asarray(jfb.wav_chunk_to_fbank(jnp.asarray(wave)))
        assert mine.shape == ref.shape == (2, 1024, 128)
        # two ffts in float32 in log-mel space
        np.testing.assert_allclose(mine, ref, atol=1e-4)

    def test_golden(self):
        """The golden records XLA's float32 FFT rounding, which torch's FFT
        does not reproduce bit for bit: in 6 of its 25,344 log-mel values
        (low-energy bins near -12.6) the two differ by up to 2.1e-4, and even
        a float64 FFT sits 1.4e-4 from the golden there. So: atol 1e-4 on
        all but 0.1% of the values, 3e-4 on every value, mean below 5e-6."""
        d = np.load(GOLDENS / "golden_v1.npz")
        diff = np.abs(tfb.fbank(_t(d["wave"])).numpy() - d["fbank"])
        assert diff.max() < 3e-4
        assert (diff > 1e-4).mean() < 1e-3
        assert diff.mean() < 5e-6

    def test_transformers_golden(self):
        """Independent oracle (huggingface ASTFeatureExtractor, float64 numpy):
        the same bounds as the JAX package's test_fbank."""
        d = np.load(GOLDENS / "fbank_transformers.npz")
        for name in ("speechish", "tone440"):
            mine = tfb.pad_or_crop(tfb.fbank(_t(d[f"wave_{name}"]))).numpy()
            ref = d[f"fbank_{name}"]
            assert mine.shape == ref.shape == (1024, 128)
            np.testing.assert_allclose(mine, ref, atol=2e-2)
            assert np.abs(mine - ref).mean() < 3e-3

    def test_tables_and_windowing_match_jax(self):
        np.testing.assert_array_equal(tfb._mel_bank_np(), jfb._mel_bank_np())
        np.testing.assert_array_equal(tfb._hann_np(), jfb._hann_np())
        wave = np.random.default_rng(7).normal(size=(1, 330000)).astype(np.float32)
        for quirk in (False, True):
            np.testing.assert_array_equal(tfb.window_waveform(wave, quirk),
                                          jfb.window_waveform(wave, quirk))
        with pytest.raises(ValueError):
            tfb.window_waveform(np.zeros(1000, np.float32))

    def test_wav_round_trip(self, tmp_path):
        wave = np.random.default_rng(8).uniform(-0.5, 0.5, size=16000).astype(np.float32)
        twavio.save_wav(tmp_path / "a.wav", wave)
        back, sr = twavio.load_wav(tmp_path / "a.wav")
        assert sr == 16000 and back.shape == (1, 16000)
        np.testing.assert_allclose(back[0], wave, atol=1 / 32768)
        twavio.save_wav(tmp_path / "b.wav", wave, sr=8000)
        assert twavio.load_wav_resampled(tmp_path / "b.wav").shape == (1, 32000)


class TestSchedulers:
    GOLD = np.load(GOLDENS / "scheduler_diffusers017.npz")

    def test_tables_and_timesteps(self):
        s = tsched.make_schedule(**SCHED_KW)
        np.testing.assert_allclose(s.betas.numpy(), self.GOLD["betas"], rtol=1e-6)
        np.testing.assert_allclose(s.alphas_cumprod.numpy(), self.GOLD["alphas_cumprod"],
                                   rtol=3e-6, atol=1e-9)
        np.testing.assert_array_equal(tsched.ddim_timesteps(s, 50, 1).numpy(),
                                      self.GOLD["ddim_timesteps"])
        j = jsched.make_schedule()
        np.testing.assert_array_equal(s.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod))
        with pytest.raises(ValueError):
            tsched.ddim_timesteps(s, 1000)

    def _trajectory(self, clip):
        s = tsched.make_schedule(**SCHED_KW)
        w1, freq, w2 = map(torch.from_numpy, eps_net_weights())
        latents = _t(self.GOLD["x_init"])
        for t in self.GOLD["ddim_timesteps"]:
            eps = torch.tanh(latents @ w1 + torch.sin(float(t) * freq * 0.01)) @ w2
            latents = tsched.ddim_step(s, eps, int(t), latents, 50, clip_sample=clip)
            yield latents.numpy()

    def test_trajectory_noclip(self):
        """Every intermediate latent of the 50-step DDIM run tracks the
        diffusers oracle (the JAX package's bound, rtol/atol 5e-4)."""
        for i, lat in enumerate(self._trajectory(False)):
            np.testing.assert_allclose(lat, self.GOLD["trajectory_noclip"][i],
                                       rtol=5e-4, atol=5e-4, err_msg=f"step {i}")

    def test_trajectory_clipped(self):
        """Clamped trajectory: boundary flips allowed, max < 1e-2, mean < 5e-4."""
        for i, lat in enumerate(self._trajectory(True)):
            diff = np.abs(lat - self.GOLD["trajectory"][i])
            assert diff.max() < 1e-2 and diff.mean() < 5e-4, f"step {i}"

    def test_ddim_step_and_coefficients_match_jax(self):
        s, j = tsched.make_schedule(), jsched.make_schedule()
        rng = np.random.default_rng(9)
        x, eps = (rng.normal(size=(3, 1, 8)).astype(np.float32) for _ in range(2))
        for steps in (50, 1):
            for t in tsched.ddim_timesteps(s, steps).tolist():
                mine = tsched.ddim_step(s, _t(eps), t, _t(x), steps).numpy()
                ref = np.asarray(jsched.ddim_step(j, jnp.asarray(eps), jnp.asarray(t),
                                                  jnp.asarray(x), steps))
                np.testing.assert_allclose(mine, ref, atol=1e-6)
                c0, c1, c2, c3 = tsched.ddim_coefficients(s, t, steps).tolist()
                fused = c2 * np.clip((x - c1 * eps) * c0, -1, 1) + c3 * eps
                np.testing.assert_allclose(fused, ref, atol=2e-6)


def test_port_imports_neither_jax_nor_amuse_tpu():
    """Import every module of amuse_tpu_torch in a fresh interpreter (the
    evaluation modules, the native loader, the host-side utilities and the
    legacy zoo among them, and every class the registry's lazy constructors
    resolve, the data parallelism and the launcher; the bpy scripts under
    viz/blender/ are no package; the attention kernel variants): no jax,
    flax, optax, orbax or transformers, no module named amuse_tpu or
    amuse_tpu.* (amuse_tpu_torch shares the prefix without the dot) and
    none of the benchmark folder."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import amuse_tpu_torch\n"
        "for m in pkgutil.walk_packages(amuse_tpu_torch.__path__, 'amuse_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from amuse_tpu_torch.models import registry\n"
        "for tag in registry.REGISTRY:\n"
        "    registry.get_model(tag)\n"
        "banned = ('jax', 'flax', 'optax', 'orbax', 'transformers', 'amuse_tpu', 'benchmarks')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in banned]\n"
        "n = sum(k.startswith('amuse_tpu_torch') for k in sys.modules)\n"
        "need = ['amuse_tpu_torch.eval.' + m for m in ('metrics', 'embedder', 'runner')]\n"
        "need += ['amuse_tpu_torch.data.' + m for m in ('bvh', 'motion_features', 'pymo_pipeline',\n"
        "                                              'textgrid', 'facial', 'corpus')]\n"
        "need += ['amuse_tpu_torch.viz.export', 'amuse_tpu_torch.viz.blender_setup',\n"
        "         'amuse_tpu_torch.utils.profiling', 'amuse_tpu_torch.cluster.sweep']\n"
        "need += ['amuse_tpu_torch.models.' + m for m in ('raw_diffusion', 'audio_legacy',\n"
        "                                                'legacy_family', 'actor', 'registry')]\n"
        "need += ['amuse_tpu_torch.diffusion.gaussian', 'amuse_tpu_torch.train.raw_diffusion',\n"
        "         'amuse_tpu_torch.audio.mfcc']\n"
        "need += ['amuse_tpu_torch.parallel.mesh', 'amuse_tpu_torch.cluster.jobs',\n"
        "         'amuse_tpu_torch.ops.kernel_variants']\n"
        "bpy = [k for k in sys.modules if k in ('bpy', 'addon_utils')]\n"
        "missing = [m for m in need + ['amuse_tpu_torch.native.loader'] if m not in sys.modules]\n"
        "print(n, bad, missing, bpy)\n"
        "sys.exit(1 if bad or missing or bpy or n < 20 else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
