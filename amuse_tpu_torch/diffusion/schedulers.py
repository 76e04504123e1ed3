"""DDPM / DDIM schedule tables and the eta=0 DDIM step, HF diffusers 0.17 semantics.

Port of ``amuse_tpu/diffusion/schedulers.py``. Parity-critical details:

  * ``scaled_linear`` betas: linspace(sqrt(b0), sqrt(b1), T)**2 in float64,
    stored float32
  * DDIM "leading" timestep spacing with ``steps_offset=1``:
    [981, 961, ..., 21, 1]
  * ``set_alpha_to_one=False``: the final step uses alphas_cumprod[0]
  * ``init_noise_sigma = 1.0``
  * epsilon prediction, eta = 0, and diffusers' default ``clip_sample=True``
    for the DDIM sampler (pred-x0 clamped to [-1, 1] every step)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """Precomputed DDPM tables (float32 CPU tensors, length = num_train_timesteps)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    init_noise_sigma: float


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> DiffusionSchedule:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unsupported beta_schedule: {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=torch.from_numpy(betas.astype(np.float32)),
        alphas_cumprod=torch.from_numpy(alphas_cumprod.astype(np.float32)),
        num_train_timesteps=num_train_timesteps,
        init_noise_sigma=1.0,
    )


def add_noise(schedule: DiffusionSchedule, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps for (B,) int
    ``timesteps`` (DDPMScheduler.add_noise), on ``sample``'s device."""
    acp = schedule.alphas_cumprod.to(sample.device)[timesteps]
    acp = acp.reshape(acp.shape + (1,) * (sample.dim() - acp.dim()))
    return torch.sqrt(acp) * sample + torch.sqrt(1.0 - acp) * noise


def ddim_timesteps(schedule: DiffusionSchedule, num_inference_steps: int = 50,
                   steps_offset: int = 1) -> torch.Tensor:
    """Descending int64 inference timesteps, diffusers "leading" spacing + offset."""
    t_train = schedule.num_train_timesteps
    if num_inference_steps > t_train:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) must be <= "
            f"num_train_timesteps ({t_train})"
        )
    if num_inference_steps == t_train and steps_offset > 0:
        raise ValueError(
            f"num_inference_steps == num_train_timesteps ({t_train}) with "
            f"steps_offset={steps_offset} indexes alphas_cumprod[{t_train}] "
            "out of bounds; use fewer inference steps"
        )
    step_ratio = t_train // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round().astype(np.int64)
    return torch.from_numpy(ts[::-1].copy() + steps_offset)


def _alpha_pair(schedule: DiffusionSchedule, timestep: int, num_inference_steps: int,
                set_alpha_to_one: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (alphas_cumprod[t], alphas_cumprod[t - ratio] or the final alpha)."""
    acp = schedule.alphas_cumprod
    prev_t = int(timestep) - schedule.num_train_timesteps // num_inference_steps
    if prev_t >= 0:
        alpha_prev = acp[prev_t]
    else:
        alpha_prev = torch.ones((), dtype=acp.dtype) if set_alpha_to_one else acp[0]
    return acp[int(timestep)], alpha_prev


def ddim_coefficients(schedule: DiffusionSchedule, timestep: int, num_inference_steps: int,
                      set_alpha_to_one: bool = False) -> torch.Tensor:
    """-> float32 (c0, c1, c2, c3) of one eta=0 DDIM step:
    pred_x0 = (x - c1 eps) * c0, clipped; x' = c2 pred_x0 + c3 eps."""
    alpha_t, alpha_prev = _alpha_pair(schedule, timestep, num_inference_steps,
                                      set_alpha_to_one)
    return torch.stack([
        1.0 / torch.sqrt(alpha_t), torch.sqrt(1.0 - alpha_t),
        torch.sqrt(alpha_prev), torch.sqrt(1.0 - alpha_prev),
    ])


def ddim_coefficient_table(schedule: DiffusionSchedule,
                           num_inference_steps: int = 50) -> torch.Tensor:
    """-> float32 (steps, 4): ``ddim_coefficients`` of every inference timestep
    in sampling order (the final step's alpha is alphas_cumprod[0]), in one
    vectorised expression."""
    acp = schedule.alphas_cumprod
    ts = ddim_timesteps(schedule, num_inference_steps)
    prev = ts - schedule.num_train_timesteps // num_inference_steps
    alpha_t = acp[ts]
    alpha_prev = torch.where(prev >= 0, acp[prev.clamp(min=0)], acp[0])
    return torch.stack([1.0 / torch.sqrt(alpha_t), torch.sqrt(1.0 - alpha_t),
                        torch.sqrt(alpha_prev), torch.sqrt(1.0 - alpha_prev)], dim=1)


def ddim_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,  # predicted epsilon
    timestep: int,
    sample: torch.Tensor,
    num_inference_steps: int = 50,
    eta: float = 0.0,
    set_alpha_to_one: bool = False,
    clip_sample: bool = True,
    clip_sample_range: float = 1.0,
) -> torch.Tensor:
    """One deterministic DDIM update x_t -> x_{t-dt} (DDIMScheduler.step, eta=0)."""
    if eta != 0.0:
        raise ValueError("stochastic DDIM (eta > 0) is not used by any shipped config")
    alpha_t, alpha_prev = _alpha_pair(schedule, timestep, num_inference_steps,
                                      set_alpha_to_one)
    pred_x0 = (sample - torch.sqrt(1.0 - alpha_t) * model_output) / torch.sqrt(alpha_t)
    if clip_sample:
        pred_x0 = torch.clamp(pred_x0, -clip_sample_range, clip_sample_range)
    direction = torch.sqrt(1.0 - alpha_prev) * model_output
    return torch.sqrt(alpha_prev) * pred_x0 + direction
