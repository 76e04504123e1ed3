"""DDIM sampling as a plain Python loop (the port's counterpart of the JAX
``lax.scan`` in ``amuse_tpu/diffusion/sampler.py``).

This is the plain version of the fused sampler kernel
(``amuse_tpu_torch/ops/denoiser_kernel.py``): on the card the pipeline runs
the whole loop as one kernel launch instead.
"""

from __future__ import annotations

from typing import Callable

import torch

from amuse_tpu_torch.diffusion.schedulers import DiffusionSchedule, ddim_step, ddim_timesteps

# denoise_fn(latents, timestep) -> predicted epsilon; conditioning is closed over.
DenoiseFn = Callable[[torch.Tensor, int], torch.Tensor]


def ddim_sample(
    schedule: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    initial_latents: torch.Tensor,
    num_inference_steps: int = 50,
    steps_offset: int = 1,
    clip_sample: bool = True,
) -> torch.Tensor:
    """Run eta=0 DDIM from ``initial_latents`` (x_T, already scaled by the
    schedule's init_noise_sigma) down to x_0.

    The caller draws the initial latents (``ddim_sample_fused`` draws them
    from a ``torch.Generator`` on the device), so both the plain loop and
    the kernel start from the same tensor.
    """
    latents = initial_latents.to(torch.float32)
    for t in ddim_timesteps(schedule, num_inference_steps, steps_offset).tolist():
        eps = denoise_fn(latents, t)
        latents = ddim_step(schedule, eps, t, latents, num_inference_steps,
                            clip_sample=clip_sample)
    return latents
