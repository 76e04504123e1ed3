"""Gesture generation pipeline: WAV -> SMPL-X animation, on the card.

Port of ``amuse_tpu/infer/pipeline.py``. Per batch of N 10 s windows:

  Kaldi fbank -> the three AST encoders (con, emo, sty) stacked as one
  (3, ...) parameter set: batched matmuls over (3, N*S, .) and one attention
  kernel (K1) launch of batch 3N per ViT block -> 50-step eta=0 DDIM in one
  sampler kernel (K3) launch -> VAE decode -> 6D -> axis-angle.

So one ``wav_to_motion`` launches K1 ``depth`` times (12) and K3 once. The
AST runs in ``dtype`` (bfloat16 by default); the denoiser and the VAE run in
float32, as in the JAX pipeline. Parameters are state dicts under the
reference AMUSE key names (``PipelineParams``).

Under ``utils.profiling.recording()`` a call records the spans
``infer.request`` (the root: ``wav_to_motion``, or ``infer_wav`` around
it), ``infer.upload`` (the audio's copy to the device), ``infer.fbank``,
``infer.ast`` (the three encoders, K1), ``infer.sampler`` (K3),
``infer.decode`` (the VAE decode and the rotations) and, in ``infer_wav``,
``infer.download`` (the motion's copy to the host).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from amuse_tpu_torch.audio import fbank as fbank_mod
from amuse_tpu_torch.core import motion as motion_mod
from amuse_tpu_torch.device import resolve_device
from amuse_tpu_torch.diffusion.schedulers import make_schedule
from amuse_tpu_torch.models.ast import ASTConfig, ASTEncoder, ast_features
from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from amuse_tpu_torch.models.vae import MotionPrior, PriorConfig
from amuse_tpu_torch.ops.denoiser_kernel import (
    SamplerWeights,
    ddim_sample_fused,
    pack_denoiser,
    schedule_conditioning,
)
from amuse_tpu_torch.utils.profiling import request_span, span

ENCODERS = ("con", "emo", "sty")  # stacking order of the AST encoders


class PipelineParams(NamedTuple):
    """State dicts (tensors or numpy arrays) under the reference key names.

    ``ast`` holds the stage-1 model's ``{con,emo,sty}_enc.*`` keys (other
    keys, such as label heads, are ignored); ``prior`` the MotionPrior's and
    ``denoiser`` the Denoiser's.
    """

    ast: dict
    prior: dict
    denoiser: dict


def _tensor(value) -> torch.Tensor:
    return value if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))


def _load(module: torch.nn.Module, sd: dict, device: torch.device) -> torch.nn.Module:
    module.load_state_dict({k: _tensor(v) for k, v in sd.items()})
    return module.to(device).eval()


def _stacked_ast(ast_sd: dict, cfg: ASTConfig, dtype: torch.dtype,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """{con,emo,sty}_enc.* -> ASTEncoder parameters stacked (3, ...) in ``dtype``."""
    with torch.device("meta"):
        template = ASTEncoder(cfg).state_dict()
    stacked = {}
    for key, ref in template.items():
        parts = []
        for name in ENCODERS:
            full = f"{name}_enc.{key}"
            if full not in ast_sd:
                raise KeyError(f"AST parameters lack {full!r}")
            t = _tensor(ast_sd[full])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{full}: shape {tuple(t.shape)}, expected {tuple(ref.shape)}")
            parts.append(t)
        stacked[key] = torch.stack(parts).to(device=device, dtype=dtype)
    return stacked


class GesturePipeline:
    """Frozen-weights inference engine; the batch dim is the number of 10 s windows."""

    def __init__(
        self,
        params: PipelineParams,
        prior_cfg: PriorConfig = PriorConfig(),
        denoiser_cfg: DenoiserConfig = DenoiserConfig(),
        ast_cfg: ASTConfig = ASTConfig(),
        dtype: torch.dtype = torch.bfloat16,
        num_inference_steps: int = 50,
        frame_based_feats: bool = True,  # must match the stage-1 training knob
        smplx_rep: str = "6D",  # motion rep the prior was trained on
        skip_trans: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.prior_cfg, self.denoiser_cfg, self.ast_cfg = prior_cfg, denoiser_cfg, ast_cfg
        self.dtype = dtype
        self.num_inference_steps = num_inference_steps
        self.frame_based_feats = frame_based_feats
        self.smplx_rep, self.skip_trans = smplx_rep, skip_trans
        self.schedule = make_schedule()
        self.prior = _load(MotionPrior(prior_cfg), params.prior, self.device)
        self.denoiser = _load(Denoiser(denoiser_cfg), params.denoiser, self.device)
        # the sampler kernel's weights (their per-CTA runs packed at first use
        # of each cluster size) and per-schedule conditioning, once
        self.sampler_weights = SamplerWeights(pack_denoiser(self.denoiser))
        self.sampler_conditioning = schedule_conditioning(self.denoiser, self.schedule,
                                                          num_inference_steps)
        # the three encoders' backbones, stacked once (label heads dropped)
        self.ast_params = _stacked_ast(params.ast, ast_cfg, dtype, self.device)

    def _chunks(self, chunks) -> torch.Tensor:
        with span("infer.upload"):
            return torch.as_tensor(chunks, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def encode_audio(self, chunks) -> dict[str, torch.Tensor]:
        """(N, 160000) chunks -> {con, emo, sty} (N, feature_dim) float32 features."""
        wave = self._chunks(chunks)
        with span("infer.fbank"):
            fb = fbank_mod.wav_chunk_to_fbank(wave)
        with span("infer.ast"):
            feats = ast_features(self.ast_params, fb, self.ast_cfg, self.frame_based_feats)
            return dict(zip(ENCODERS, feats.unbind(0)))

    @torch.inference_mode()
    def generate_latents(self, con, emo=None, sty=None,
                         generator: Optional[torch.Generator] = None,
                         initial_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """eta=0 DDIM -> motion latents (N, 1, latent_dim) (kernel K3 on the card)."""
        with span("infer.sampler"):
            return ddim_sample_fused(
                self.denoiser, self.schedule, con, emo, sty, self.num_inference_steps,
                initial_latents=initial_latents, generator=generator,
                packed=self.sampler_weights, conditioning=self.sampler_conditioning,
            )

    @torch.inference_mode()
    def decode_motion(self, latents: torch.Tensor):
        """latents -> (poses (N, 300, 55, 3) axis-angle, trans (N, 300, 3))."""
        with span("infer.decode"):
            feats = self.prior.decode(latents, self.prior_cfg.window)
            return motion_mod.defeaturize(feats, self.smplx_rep, self.skip_trans)

    @torch.inference_mode()
    def encode_motion(self, feats: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Rep-space windows (N, 300, nfeats) -> sampled latents (N, 1, latent_dim)."""
        z, _ = self.prior.encode(feats.to(self.device), generator)
        return z

    @torch.inference_mode()
    def encode_motion_mu(self, feats: torch.Tensor) -> torch.Tensor:
        """Posterior mean latents (no reparameterisation noise)."""
        mu, _ = self.prior.encode_params(feats.to(self.device))
        return mu

    def motion_feats(self, motion: torch.Tensor) -> torch.Tensor:
        """Raw (..., T, 168) axis-angle+trans windows -> the prior's feature space."""
        return motion_mod.featurize(motion, self.smplx_rep, self.skip_trans)

    @torch.inference_mode()
    def wav_to_motion(self, chunks, generator: Optional[torch.Generator] = None,
                      initial_latents: Optional[torch.Tensor] = None):
        """(N, 160000) chunks -> (poses (N, 300, 55, 3), trans (N, 300, 3))."""
        with request_span("infer.request"):
            cond = self.encode_audio(chunks)
            latents = self.generate_latents(cond["con"], cond["emo"], cond["sty"],
                                            generator, initial_latents)
            return self.decode_motion(latents)

    def infer_wav(self, waveform: np.ndarray, seed: int = 0) -> dict:
        """Full-length waveform -> dict of numpy animation data (jaw zeroed for export)."""
        with request_span("infer.request"):
            chunks = fbank_mod.window_waveform(waveform)
            generator = torch.Generator(device=self.device).manual_seed(seed)
            poses, trans = self.wav_to_motion(chunks, generator=generator)
            with span("infer.download"):
                return {
                    "poses": motion_mod.zero_jaw(poses).cpu().numpy(),  # (n_windows, 300, 55, 3)
                    "trans": trans.cpu().numpy(),  # (n_windows, 300, 3)
                    "fps": 30.0,
                }


def init_random_params(
    seed: int = 0,
    prior_cfg: PriorConfig = PriorConfig(),
    denoiser_cfg: DenoiserConfig = DenoiserConfig(),
    ast_cfg: ASTConfig = ASTConfig(),
) -> PipelineParams:
    """Random-weight pipeline params (reference keys), drawn from ``seed`` on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ast = {}
        for name in ENCODERS:
            ast.update({f"{name}_enc.{k}": v for k, v in ASTEncoder(ast_cfg).state_dict().items()})
        prior = MotionPrior(prior_cfg).state_dict()
        denoiser = Denoiser(denoiser_cfg).state_dict()
    return PipelineParams(ast=ast, prior=prior, denoiser=denoiser)
