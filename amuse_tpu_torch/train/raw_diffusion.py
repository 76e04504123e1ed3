"""Training step of the legacy raw-pose diffusion baseline ("diffusion" tag).

Port of ``amuse_tpu/train/raw_diffusion.py``: x0-prediction MSE (or
epsilon) with loss-aware importance-sampled timesteps (uniform ones with
``loss_aware=False``), weighted by 1 / (T p_t), then AdamW with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
parameter; fused on CUDA), then the sampler state takes the step's
per-sample losses. ``sample_fn`` is ancestral sampling with the model.

A step's draws are the timesteps and the noise (``RawStepDraw``), drawn from
the step's ``torch.Generator`` or injected, so a test can feed the JAX
step's own draws; dropout masks come from the same generator after them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from amuse_tpu_torch.device import resolve_device
from amuse_tpu_torch.diffusion import gaussian as G
from amuse_tpu_torch.models.raw_diffusion import RawDenoiserConfig, RawPoseDenoiser


@dataclass(frozen=True)
class RawTrainConfig:
    learning_rate: float = 1e-4
    num_timesteps: int = 1000
    schedule: str = "cosine"  # MDM default
    predict: str = "x0"  # MDM predicts x0
    loss_aware: bool = True


OPTAX_ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch's is 0.01)


class RawStepDraw(NamedTuple):
    t: torch.Tensor  # (B,) int64 timesteps
    noise: torch.Tensor  # (B, T, nfeats) epsilon


class RawTrainState:
    """The denoiser, its AdamW optimizer, the loss-aware sampler state and the step count."""

    def __init__(self, model: RawPoseDenoiser, optimizer: torch.optim.Optimizer,
                 sampler_state: G.LossAwareState, step: int = 0):
        self.model, self.optimizer = model, optimizer
        self.sampler_state, self.step = sampler_state, step


def make_diffusion(cfg: RawTrainConfig, device: str | torch.device) -> G.GaussianDiffusion:
    betas = (G.cosine_betas(cfg.num_timesteps) if cfg.schedule == "cosine"
             else G.linear_betas(cfg.num_timesteps))
    return G.make_gaussian_diffusion(betas, device)


def init_state(seed: int, model_cfg: RawDenoiserConfig = RawDenoiserConfig(),
               cfg: RawTrainConfig = RawTrainConfig(),
               device: str | torch.device = "cuda") -> RawTrainState:
    """Random float32 weights drawn from ``seed`` on the CPU, moved to ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RawPoseDenoiser(model_cfg)
    model.to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=OPTAX_ADAMW_WEIGHT_DECAY,
                            fused=dev.type == "cuda")
    return RawTrainState(model, opt, G.LossAwareState.create(cfg.num_timesteps, device=dev))


def make_train_step(model_cfg: RawDenoiserConfig = RawDenoiserConfig(),
                    cfg: RawTrainConfig = RawTrainConfig()):
    """-> ``(train_step, sample_fn)``.

    ``train_step(state, batch, generator=None, draw=None) -> logs``: one step
    in place over ``batch`` {"motion" (B, T, nfeats), "con" (B, C), "emo"
    (B, C)}; the logs ``loss`` and ``loss_unweighted`` are device tensors.
    ``sample_fn(model, batch_cond, generator=None, num_frames=None,
    noise=None)``: ancestral sampling (``G.p_sample_loop``) in eval mode.
    """
    tables: dict = {}

    def diffusion(device: torch.device) -> G.GaussianDiffusion:
        if device not in tables:
            tables[device] = make_diffusion(cfg, device)
        return tables[device]

    def train_step(state: RawTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draw: Optional[RawStepDraw] = None) -> dict:
        model, motion = state.model, batch["motion"]
        gd = diffusion(motion.device)
        b = motion.shape[0]
        model.train()
        p = G.loss_aware_weights(state.sampler_state) if cfg.loss_aware else None
        if draw is None:
            t = (torch.multinomial(p, b, replacement=True, generator=generator)
                 if cfg.loss_aware else
                 torch.randint(0, cfg.num_timesteps, (b,), generator=generator,
                               device=motion.device))
            draw = RawStepDraw(t, torch.randn(motion.shape, generator=generator,
                                              device=motion.device))
        weights = (1.0 / (p.shape[0] * p[draw.t]) if cfg.loss_aware
                   else torch.ones((b,), device=motion.device))

        def model_fn(x_t, tt):
            return model(x_t, tt, batch["con"], batch["emo"], generator)

        per_sample, _ = G.training_loss(gd, model_fn, motion, draw.t, draw.noise, cfg.predict)
        loss = torch.mean(per_sample * weights)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        per_sample = per_sample.detach()
        if cfg.loss_aware:
            state.sampler_state = G.loss_aware_update(state.sampler_state, draw.t, per_sample)
        state.step += 1
        return {"loss": loss.detach(), "loss_unweighted": torch.mean(per_sample)}

    @torch.no_grad()
    def sample_fn(model: RawPoseDenoiser, batch_cond: dict,
                  generator: Optional[torch.Generator] = None,
                  num_frames: Optional[int] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        frames = num_frames or model_cfg.window
        con = batch_cond["con"]
        model.eval()

        def model_fn(x_t, tt):
            return model(x_t, tt, con, batch_cond["emo"])

        return G.p_sample_loop(diffusion(con.device), model_fn,
                               (con.shape[0], frames, model_cfg.nfeats), generator, noise,
                               cfg.predict)

    return train_step, sample_fn
