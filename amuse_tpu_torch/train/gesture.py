"""Stage-2 training: joint motion-prior VAE + latent-diffusion denoiser (LPDM).

Port of ``amuse_tpu/train/gesture.py`` (reference
``trainer.train_prior_latdiff_forward_backward_v2``). One step, in order:

  1. axis-angle -> the configured features (6D + trans, 333);
  2. the VAE encode and decode, with gradient and dropout;
  3. the re-encode of the motion without gradient (dropout still on);
  4. DDPM noising at t ~ U[0, 1000) and epsilon prediction by the denoiser;
  5. the monitor, without gradient and with dropout off: the 50-step eta=0
     DDIM pass (kernel K3 on the card, its weights packed afresh from the
     denoiser as it stands, since they change every step), the VAE decode
     and three SMPL-X vertex forwards (reference, reconstruction, sample);
  6. ``losses.lpdm_losses`` (the monitor terms enter the total detached),
     backward, and AdamW over the prior's and the denoiser's parameters
     (torch's defaults: weight decay 0.01, fused on CUDA).

Randomness comes from one ``torch.Generator`` per step on the step's device,
seeded from (seed, epoch, step) by ``train.audio.step_generator``, so a
resumed run replays the same draws: first the ``StepNoise`` draws, then the
dropout masks in the order the layers run.

Data parallel (``grad_sync``, ``parallel/mesh.py``): each rank's batch is its
rows of the global batch. Every rank draws the global batch's ``StepNoise``
and every dropout mask, at the global batch's shape, from the one generator
and keeps its rows (``models.transformer.dropout``), so a W-rank step is
the single-process step, dropout included. K3 monitors the rank's own
windows. The gradients are all-reduced between ``backward`` and the
optimizer's step, and the returned logs are the global batch's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from amuse_tpu_torch.core import motion as motion_mod
from amuse_tpu_torch.core import smplx as smplx_mod
from amuse_tpu_torch.diffusion.schedulers import DiffusionSchedule, add_noise, make_schedule
from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from amuse_tpu_torch.models.vae import MotionPrior, PriorConfig
from amuse_tpu_torch.ops.denoiser_kernel import ddim_sample_fused
from amuse_tpu_torch.parallel.mesh import GradSync
from amuse_tpu_torch.train import losses as L
from amuse_tpu_torch.train.checkpoint import load_optimizer


@dataclass(frozen=True)
class GestureTrainConfig:
    learning_rate: float = 1e-4  # configs/base_new.json lr_base
    batch_size: int = 32  # configs/base_new.json:281
    epochs: int = 12_000  # configs/base_new.json:293
    num_inference_steps: int = 50
    monitor_every: int = 1  # the reference runs the DDIM monitor every step
    vtex_displacement: bool = True  # configs/base_new.json vtex_displacement
    checkpoint_every: int = 200  # model_save_freq
    # the motion representation the prior and denoiser train on: "6D" + trans
    # (333 features) or raw axis-angle "3D" (168, or 165 with skip_trans);
    # PriorConfig.nfeats must match (cli/main.py::_model_cfgs)
    smplx_rep: str = "6D"
    skip_trans: bool = False


class StepNoise(NamedTuple):
    """One step's draws apart from dropout (float32 unless said)."""

    enc: torch.Tensor  # (B, tokens, D) reparameterisation noise of the VAE pass
    enc2: torch.Tensor  # the same, of the re-encode
    t: torch.Tensor  # (B,) int64 diffusion timesteps in [0, num_train_timesteps)
    noise: torch.Tensor  # (B, tokens, D) epsilon
    latents: torch.Tensor  # (B, tokens, D) initial latents of the DDIM monitor


def draw_step_noise(generator: Optional[torch.Generator], batch_size: int,
                    prior_cfg: PriorConfig, schedule: DiffusionSchedule,
                    device: torch.device) -> StepNoise:
    shape = (batch_size, prior_cfg.latent_tokens, prior_cfg.latent_dim)

    def normal():
        return torch.randn(shape, generator=generator, device=device)

    enc, enc2 = normal(), normal()
    t = torch.randint(0, schedule.num_train_timesteps, (batch_size,), generator=generator,
                      device=device)
    return StepNoise(enc, enc2, t, normal(), normal() * schedule.init_noise_sigma)


class GestureTrainState:
    """The prior, the denoiser, their AdamW optimizer and the count of steps."""

    def __init__(self, prior: MotionPrior, denoiser: Denoiser,
                 optimizer: torch.optim.Optimizer, step: int = 0):
        self.prior, self.denoiser, self.optimizer, self.step = prior, denoiser, optimizer, step

    def state_dict(self) -> dict:
        """``{"params": {"prior", "denoiser"}, "optimizer", "step"}``: the layout
        ``utils/checkpoint_io.py`` loads a run directory from."""
        return {"params": {"prior": self.prior.state_dict(),
                           "denoiser": self.denoiser.state_dict()},
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Parameters, then the optimizer and step where ``state`` has them (a
        checkpoint of bare parameters keeps fresh moments)."""
        self.prior.load_state_dict(state["params"]["prior"])
        self.denoiser.load_state_dict(state["params"]["denoiser"])
        load_optimizer(self.optimizer, state.get("optimizer"))
        self.step = int(state.get("step", self.step))


def make_optimizer(prior: MotionPrior, denoiser: Denoiser,
                   cfg: GestureTrainConfig) -> torch.optim.AdamW:
    """AdamW(lr) with torch's default weight decay 0.01 (trainer.py:184), over
    the prior's parameters then the denoiser's; fused on CUDA."""
    params = [*prior.parameters(), *denoiser.parameters()]
    return torch.optim.AdamW(params, lr=cfg.learning_rate, weight_decay=0.01,
                             fused=params[0].device.type == "cuda")


def init_state(seed: int, prior_cfg: PriorConfig = PriorConfig(),
               denoiser_cfg: DenoiserConfig = DenoiserConfig(),
               cfg: GestureTrainConfig = GestureTrainConfig(),
               device: str | torch.device = "cuda") -> GestureTrainState:
    """Random float32 weights drawn from ``seed`` on the CPU, moved to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        prior, denoiser = MotionPrior(prior_cfg), Denoiser(denoiser_cfg)
    prior.to(device)
    denoiser.to(device)
    return GestureTrainState(prior, denoiser, make_optimizer(prior, denoiser, cfg))


def to_feats6d(feats: torch.Tensor, rep: str, skip_trans: bool) -> torch.Tensor:
    """The representation's features -> 6D + trans features for the vertex monitors."""
    if rep == "6D":
        return feats
    aa, tr = motion_mod.defeaturize(feats, rep, skip_trans)
    flat = aa.reshape(aa.shape[:-2] + (-1,))
    return motion_mod.axis_angle_to_feats6d(torch.cat([flat, tr], dim=-1))


@contextlib.contextmanager
def eval_mode(*modules: torch.nn.Module):
    """Dropout off inside the block; each module's mode restored after it."""
    modes = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def loss_fn(state: GestureTrainState, batch: dict, cfg: GestureTrainConfig,
            schedule: DiffusionSchedule, noise: StepNoise,
            generator: Optional[torch.Generator] = None, with_monitor: bool = True,
            smplx_model: Optional[smplx_mod.SmplxModel] = None,
            soc: Optional[smplx_mod.SocTables] = None) -> tuple[torch.Tensor, dict]:
    """The LPDM objective on one batch of device tensors -> (total, logs).

    ``batch``: motion (B, T, 168) axis-angle + trans; con, emo, sty (B,
    cond_dim) frozen AST features; betas (B, n_betas). Dropout follows the
    modules' modes and draws from ``generator``; the vertex monitors run
    where ``soc`` (``prepare_soc`` of ``smplx_model``) is given.
    """
    prior, denoiser = state.prior, state.denoiser
    m6 = motion_mod.featurize(batch["motion"], cfg.smplx_rep, cfg.skip_trans)
    window = prior.cfg.window
    con, emo, sty = batch["con"], batch["emo"], batch["sty"]

    # the VAE pass, with gradient
    z, (mu, logvar) = prior.encode(m6, generator, noise=noise.enc)
    m_rst = prior.decode(z, window, generator=generator)

    # the diffusion pass: gradient to the denoiser only; the re-encode keeps
    # the prior's mode (dropout on in training, as the reference)
    with torch.no_grad():
        z_sg = prior.encode(m6, generator, noise=noise.enc2)[0]
    noisy = add_noise(schedule, z_sg, noise.noise, noise.t)
    noise_pred = denoiser(noisy, noise.t, con, emo, sty, generator)

    gen_m_rst = rec_v = gen_v = None
    if with_monitor:
        # deterministic (dropout off), as the JAX package's monitor; K3 on the
        # card packs the denoiser's weights as they are now (packed=None)
        with torch.no_grad(), eval_mode(prior, denoiser):
            gen_z = ddim_sample_fused(denoiser, schedule, con, emo, sty,
                                      cfg.num_inference_steps, initial_latents=noise.latents)
            gen_m_rst = prior.decode(gen_z, window)
            if soc is not None:
                betas = batch["betas"]

                def verts(feats):
                    return smplx_mod.soc_monitor_vertices(
                        smplx_model, soc, to_feats6d(feats, cfg.smplx_rep, cfg.skip_trans),
                        betas)

                v_ref = verts(m6)
                rec_v = (verts(m_rst.detach()), v_ref)
                gen_v = (verts(gen_m_rst), v_ref)
    return L.lpdm_losses(m6, m_rst, mu, logvar, noise.noise, noise_pred, gen_m_rst,
                         rec_v, gen_v)


def make_train_step(prior_cfg: PriorConfig = PriorConfig(),
                    denoiser_cfg: DenoiserConfig = DenoiserConfig(),
                    cfg: GestureTrainConfig = GestureTrainConfig(),
                    smplx_model: Optional[smplx_mod.SmplxModel] = None,
                    with_monitor: bool = True, grad_sync: Optional[GradSync] = None):
    """-> ``train_step(state, batch, generator=None, stochastic=True, noise=None)``.

    One step in place; returns the logs (detached device tensors).
    ``stochastic=False`` turns dropout off; ``noise`` replaces the
    ``StepNoise`` draws (the comparison tests inject both). The vertex
    monitors run when ``cfg.vtex_displacement`` and ``smplx_model`` (on the
    step's device) is given. With ``grad_sync`` the step is one rank's of a
    data-parallel step: ``batch`` holds its rows, ``noise`` (drawn or given)
    is the global batch's and the rank keeps its rows, as it does of every
    dropout mask, the gradients are all-reduced before the optimizer's step,
    and the logs are global.
    """
    schedule = make_schedule()
    do_vtex = with_monitor and cfg.vtex_displacement and smplx_model is not None
    soc = smplx_mod.prepare_soc(smplx_model) if do_vtex else None

    def train_step(state: GestureTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None, stochastic: bool = True,
                   noise: Optional[StepNoise] = None) -> dict:
        state.prior.train(stochastic)
        state.denoiser.train(stochastic)
        b = batch["motion"].shape[0]
        world = 1 if grad_sync is None else grad_sync.size
        if noise is None:
            noise = draw_step_noise(generator, b * world, prior_cfg, schedule,
                                    batch["motion"].device)
        dropout_gen = generator
        if grad_sync is not None:
            if noise.t.shape[0] != b * world:
                raise ValueError(f"noise for {noise.t.shape[0]} rows; the global batch "
                                 f"has {b * world}")
            noise = StepNoise(*(x[grad_sync.rows(b)] for x in noise))
            dropout_gen = grad_sync.dropout_draws(generator)
        total, logs = loss_fn(state, batch, cfg, schedule, noise, dropout_gen, with_monitor,
                              smplx_model, soc)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if grad_sync is not None:
            grad_sync.all_reduce([*state.prior.parameters(), *state.denoiser.parameters()])
            logs = grad_sync.mean_logs(logs)
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}

    return train_step


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch {motion, con, emo, sty, betas} -> float32 device tensors."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in batch.items()}
