"""Shared pieces of the port's editing and data tests (CPU, float32).

One set of small weights drives a JAX pipeline and its port: reference-keyed
state dicts (``tests/torch_sd.py``) that the port loads directly and JAX
through ``torch_import``, at the widths of ``tests/test_editing.py``. The
two frameworks draw different random numbers, so the noise is injected on
both sides by the wrappers below: the initial DDIM latents and the VAE's
reparameterisation noise come from numpy, seeded with the seed the code
under test passed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from amuse_tpu.infer.pipeline import GesturePipeline as JPipeline
from amuse_tpu.infer.pipeline import PipelineParams as JParams
from amuse_tpu.models.ast import ASTConfig as JAST
from amuse_tpu.models.denoiser import DenoiserConfig as JDen
from amuse_tpu.models.vae import MotionPrior as JMotionPrior
from amuse_tpu.models.vae import PriorConfig as JPrior
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch.audio.wavio import save_wav
from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
from amuse_tpu_torch.infer.pipeline import GesturePipeline, PipelineParams
from amuse_tpu_torch.models.ast import ASTConfig
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from tests import torch_sd

PRIOR_KW = dict(nfeats=333, latent_dim=16, ff_size=32, num_layers=3, num_heads=2, window=12)
DEN_KW = dict(latent_dim=16, ff_size=32, num_layers=3, num_heads=2, cond_dim=8)
AST_KW = dict(embed_dim=16, depth=1, num_heads=2, feature_dim=8)
STEPS = 2
# float32 bounds of tests/test_torch_port_pipeline.py: features atol 1e-4;
# poses (as rotation matrices, equivalent near angle pi) and translation
# atol 1e-3, rtol 1e-3 (stacks and a DDIM loop of float32 rounding in two
# frameworks)
FEAT_ATOL = 1e-4
POSE_ATOL = POSE_RTOL = 1e-3


def make_pipes(seed: int = 0):
    """(JAX pipeline, port pipeline on the CPU) from one set of reference-keyed
    state dicts: loaded by the port directly, by JAX through torch_import."""
    rng = np.random.default_rng(seed)
    ast, prior, den = {}, {}, {}
    torch_sd.disentangler_sd(rng, ast, embed=16, depth=1, feature_dim=8, fusion_dim=8,
                             out_frames=4, out_bins=4)
    torch_sd.prior_sd(rng, prior, d=16, ff=32, layers=3)
    torch_sd.denoiser_sd(rng, den, d=16, ff=32, layers=3, cond=8)
    jparams = JParams(ast=ti.ast_disentangler_from_torch(ast, depth=1),
                      prior=ti.motion_prior_from_torch(prior, num_layers=3),
                      denoiser=ti.denoiser_from_torch(den, num_layers=3))
    jpipe = JPipeline(jparams, JPrior(**PRIOR_KW), JDen(**DEN_KW), JAST(**AST_KW),
                      dtype=jnp.float32, num_inference_steps=STEPS)
    port = GesturePipeline(PipelineParams(ast=ast, prior=prior, denoiser=den),
                           PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW),
                           ASTConfig(**AST_KW), dtype=torch.float32,
                           num_inference_steps=STEPS, device="cpu")
    return jpipe, port


def x0_for(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng([seed, n]).normal(size=(n, 1, 16)).astype(np.float32)


def motion_noise(seed: int, shape) -> np.ndarray:
    return np.random.default_rng([seed, 7]).normal(size=tuple(shape)).astype(np.float32)


class _Wrapped:
    def __init__(self, pipe):
        self.pipe = pipe

    def __getattr__(self, name):
        return getattr(self.pipe, name)


class JaxNoise(_Wrapped):
    """The JAX pipeline with numpy noise in place of ``jax.random`` draws."""

    @staticmethod
    def _seed(key) -> int:
        return int(np.asarray(jax.random.key_data(key)).ravel()[-1])

    def generate_latents(self, rng, con, emo=None, sty=None, initial_latents=None):
        x0 = jnp.asarray(x0_for(self._seed(rng), con.shape[0]))
        return self.pipe.generate_latents(None, con, emo, sty, initial_latents=x0)

    def encode_motion(self, rng, feats):
        mu, logvar = JMotionPrior(self.pipe.prior_cfg).apply(
            {"params": self.pipe.params.prior}, feats, method="encode_params")
        return mu + jnp.exp(0.5 * logvar) * motion_noise(self._seed(rng), mu.shape)


class PortNoise(_Wrapped):
    """The port's pipeline with the same numpy noise, seeded from the generator."""

    def generate_latents(self, con, emo=None, sty=None, generator=None,
                         initial_latents=None):
        x0 = x0_for(generator.initial_seed(), con.shape[0])
        return self.pipe.generate_latents(con, emo, sty, initial_latents=torch.from_numpy(x0))

    @torch.inference_mode()
    def encode_motion(self, feats, generator=None):
        shape = (feats.shape[0], 1, self.pipe.prior_cfg.latent_dim)
        noise = torch.from_numpy(motion_noise(generator.initial_seed(), shape))
        z, _ = self.pipe.prior.encode(feats, noise=noise)
        return z


def assert_motion_close(got, want) -> None:
    """(poses, trans) of the port against JAX's, as numpy."""
    poses, trans = got
    jposes, jtrans = want
    np.testing.assert_allclose(trans, np.asarray(jtrans), atol=POSE_ATOL, rtol=POSE_RTOL)
    np.testing.assert_allclose(
        axis_angle_to_matrix(torch.as_tensor(np.asarray(poses))).numpy(),
        axis_angle_to_matrix(torch.as_tensor(np.array(jposes))).numpy(),
        atol=POSE_ATOL, rtol=POSE_RTOL)


def write_take(root, actor_id: int, name: str, take: str, windows: int, rng,
               motion: bool = True, emotion: int = 0, extra_samples: int = 5000):
    """One BEAT take under ``root/beat`` (wav, emotion CSV) and, with
    ``motion``, its MoSh npz under ``root/mosh``."""
    d = root / "beat" / str(actor_id)
    d.mkdir(parents=True, exist_ok=True)
    stem = f"{actor_id}_{name}_{take}"
    save_wav(d / f"{stem}.wav",
             rng.normal(scale=0.05, size=windows * 160000 + extra_samples).astype(np.float32))
    (d / f"{stem}.csv").write_text(f"0,{emotion}\n1,{emotion}\n")
    if motion:
        (root / "mosh").mkdir(exist_ok=True)
        t = windows * 300 + 7
        np.savez(root / "mosh" / f"{stem}.npz",
                 poses=(0.2 * rng.normal(size=(t, 165))).astype(np.float32),
                 trans=(0.1 * rng.normal(size=(t, 3))).astype(np.float32))
