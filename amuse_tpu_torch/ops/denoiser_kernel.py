"""The whole-loop DDIM sampler: kernel K3 and its plain version.

``ddim_sample_fused`` runs the eta=0 DDIM loop of the latent denoiser. For
CUDA tensors it launches the hand-written Hopper kernel
``csrc/ddim_sampler.cu`` once for all steps (it replaces the TPU kernel
``amuse_tpu/ops/denoiser_kernel.py::_sampler_kernel``; its source note gives
the bound and the design). For CPU tensors it runs the plain version,
``ddim_sample_reference``: the Python DDIM loop over the torch ``Denoiser``.
There is no fallback: an unsupported CUDA input raises.
``ddim_sample_fused.launches`` counts kernel launches.

As in the JAX package, the latent-independent parts are computed outside
the kernel in torch (``precompute_conditioning``): the per-step time tokens
with pos[1] folded in, the condition tokens with their positions, the
per-step DDIM coefficients (c0..c3, equal to ``ddim_step``'s, including
alphas_cumprod[0] on the last step) and pos[0].
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from amuse_tpu_torch.diffusion.sampler import ddim_sample
from amuse_tpu_torch.diffusion.schedulers import (
    DiffusionSchedule,
    ddim_coefficients,
    ddim_timesteps,
)
from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
from amuse_tpu_torch.ops import _build

MAX_REAL_TOKENS = 5  # latent, time, content, emotion, style


class PackedDenoiser(NamedTuple):
    """Per-layer weights of the skip stack stacked in layer order
    (in_0.., mid, out_0..), float32, (in, out) layout as the JAX package's."""

    wq: torch.Tensor  # (L, D, D)
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: torch.Tensor  # (L, D)
    bk: torch.Tensor
    bv: torch.Tensor
    bo: torch.Tensor
    w1: torch.Tensor  # (L, D, FF)
    b1: torch.Tensor  # (L, FF)
    w2: torch.Tensor  # (L, FF, D)
    b2: torch.Tensor  # (L, D)
    ln_scale: torch.Tensor  # (L, 2, D)
    ln_bias: torch.Tensor  # (L, 2, D)
    wskip: torch.Tensor  # ((L-1)/2, 2D, D)
    bskip: torch.Tensor  # ((L-1)/2, D)
    final_scale: torch.Tensor  # (D,)
    final_bias: torch.Tensor  # (D,)


@torch.no_grad()
def pack_denoiser(denoiser: Denoiser) -> PackedDenoiser:
    """Torch ``Denoiser`` -> the kernel's stacked float32 weights."""
    enc = denoiser.encoder
    layers = [*enc.input_blocks, enc.middle_block, *enc.output_blocks]
    d = denoiser.cfg.latent_dim

    def stack(fn):
        return torch.stack([fn(layer).detach().float() for layer in layers]).contiguous()

    def stack_t(fn):  # torch (out, in) -> (in, out)
        return stack(lambda layer: fn(layer).T)

    def skip(fn):
        return torch.stack([fn(lin).detach().float() for lin in enc.linear_blocks]).contiguous()

    return PackedDenoiser(
        wq=stack_t(lambda l: l.self_attn.in_proj_weight[:d]),
        wk=stack_t(lambda l: l.self_attn.in_proj_weight[d : 2 * d]),
        wv=stack_t(lambda l: l.self_attn.in_proj_weight[2 * d :]),
        wo=stack_t(lambda l: l.self_attn.out_proj.weight),
        bq=stack(lambda l: l.self_attn.in_proj_bias[:d]),
        bk=stack(lambda l: l.self_attn.in_proj_bias[d : 2 * d]),
        bv=stack(lambda l: l.self_attn.in_proj_bias[2 * d :]),
        bo=stack(lambda l: l.self_attn.out_proj.bias),
        w1=stack_t(lambda l: l.linear1.weight),
        b1=stack(lambda l: l.linear1.bias),
        w2=stack_t(lambda l: l.linear2.weight),
        b2=stack(lambda l: l.linear2.bias),
        ln_scale=stack(lambda l: torch.stack([l.norm1.weight, l.norm2.weight])),
        ln_bias=stack(lambda l: torch.stack([l.norm1.bias, l.norm2.bias])),
        wskip=skip(lambda lin: lin.weight.T),
        bskip=skip(lambda lin: lin.bias),
        final_scale=enc.norm.weight.detach().float().clone(),
        final_bias=enc.norm.bias.detach().float().clone(),
    )


@torch.no_grad()
def precompute_conditioning(
    denoiser: Denoiser,
    schedule: DiffusionSchedule,
    con: torch.Tensor,  # (B, cond_dim)
    emo: Optional[torch.Tensor] = None,
    sty: Optional[torch.Tensor] = None,
    num_steps: int = 50,
):
    """-> (time_tokens (steps, D), cond (B, n_cond, D), coeffs (steps, 4), pos0 (D,)),
    all float32 on ``con``'s device."""
    device = con.device
    ts = ddim_timesteps(schedule, num_steps)
    pe = denoiser.query_pos.pe.detach()[:, 0].float()  # (max_len, D)
    time_tokens = denoiser.time_tokens(ts.to(device)) + pe[1]
    cond_list = denoiser.cond_tokens(con, emo, sty)
    cond = torch.stack(cond_list, dim=1) + pe[2 : 2 + len(cond_list)]
    coeffs = torch.stack([ddim_coefficients(schedule, t, num_steps) for t in ts.tolist()])
    return (time_tokens.contiguous(), cond.contiguous(), coeffs.to(device).contiguous(),
            pe[0].contiguous())


@torch.no_grad()
def ddim_sample_reference(
    denoiser: Denoiser,
    schedule: DiffusionSchedule,
    con: torch.Tensor,
    emo: Optional[torch.Tensor],
    sty: Optional[torch.Tensor],
    initial_latents: torch.Tensor,  # (B, latent_tokens, D)
    num_steps: int = 50,
    clip_sample: bool = True,
) -> torch.Tensor:
    """Plain version: the DDIM loop over the torch Denoiser, one call per step."""
    return ddim_sample(schedule, lambda x, t: denoiser(x, t, con, emo, sty), initial_latents,
                       num_steps, clip_sample=clip_sample)


@torch.no_grad()
def ddim_sample_fused(
    denoiser: Denoiser,
    schedule: DiffusionSchedule,
    con: torch.Tensor,
    emo: Optional[torch.Tensor] = None,
    sty: Optional[torch.Tensor] = None,
    num_steps: int = 50,
    initial_latents: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    clip_sample: bool = True,
    packed: Optional[PackedDenoiser] = None,
) -> torch.Tensor:
    """Sample motion latents (B, latent_tokens, D) float32 by eta=0 DDIM.

    Initial latents come from ``initial_latents`` or from a N(0, 1) draw of
    ``generator`` on ``con``'s device. ``packed`` is ``pack_denoiser``'s
    result, packed once by callers that sample repeatedly.
    """
    cfg = denoiser.cfg
    b, device = con.shape[0], con.device
    shape = (b, cfg.latent_tokens, cfg.latent_dim)
    if initial_latents is None:
        x0 = torch.randn(shape, generator=generator, device=device,
                         dtype=torch.float32) * schedule.init_noise_sigma
    else:
        x0 = initial_latents.to(device=device, dtype=torch.float32)
        if tuple(x0.shape) != shape:
            raise ValueError(f"initial_latents must be {shape}, got {tuple(x0.shape)}")
    if device.type == "cpu":
        return ddim_sample_reference(denoiser, schedule, con, emo, sty, x0, num_steps,
                                     clip_sample)
    if device.type != "cuda":
        raise ValueError(f"ddim_sample_fused runs on CUDA or CPU tensors, got {device}")
    return _sample_cuda(denoiser, schedule, con, emo, sty, x0, num_steps, clip_sample,
                        pack_denoiser(denoiser) if packed is None else packed)


def _sample_cuda(denoiser, schedule, con, emo, sty, x0, num_steps, clip_sample, packed):
    cfg = denoiser.cfg
    if cfg.latent_tokens != 1:
        raise ValueError(f"the sampler kernel takes one latent token, got {cfg.latent_tokens}")
    if cfg.activation != "gelu" or cfg.normalize_before:
        raise ValueError("the sampler kernel runs post-norm GELU layers only")
    if cfg.latent_dim % 4 or cfg.ff_size % 4 or max(cfg.latent_dim, cfg.ff_size) > 2048:
        raise ValueError("the sampler kernel takes latent_dim and ff_size in multiples "
                         "of 4, at most 2048")
    if any(p.device != con.device for p in denoiser.parameters()):
        raise ValueError("the denoiser must lie on the conditions' device")
    if any(t.device != con.device or not t.is_contiguous() for t in packed):
        raise ValueError("packed weights must be contiguous on the conditions' device")
    conditioning = precompute_conditioning(denoiser, schedule, con, emo, sty, num_steps)
    if 2 + conditioning[1].shape[1] > MAX_REAL_TOKENS:
        raise ValueError(f"the sampler kernel takes at most {MAX_REAL_TOKENS} tokens")
    return launch_sampler(packed, conditioning, x0, cfg, clip_sample)


def launch_sampler(packed: PackedDenoiser, conditioning: tuple, x0: torch.Tensor,
                   cfg: DenoiserConfig, clip_sample: bool = True) -> torch.Tensor:
    """One launch of the sampler kernel on checked CUDA inputs.

    ``conditioning`` is ``precompute_conditioning``'s result and ``x0`` the
    (B, 1, D) float32 initial latents; ``ddim_sample_fused`` checks both.
    Exposed so that a measurement can time the kernel without the
    conditioning that precedes it.
    """
    time_tokens, cond, coeffs, pos0 = conditioning
    b, d = x0.shape[0], cfg.latent_dim
    x0 = x0.reshape(b, d).contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=x0.device)
    lib = _build.load("ddim_sampler")
    fn = lib.ddim_sampler
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(
        time_tokens.data_ptr(), cond.data_ptr(), coeffs.data_ptr(), pos0.data_ptr(),
        x0.data_ptr(), *(t.data_ptr() for t in packed), out.data_ptr(),
        b, 2 + cond.shape[1], time_tokens.shape[0], d, cfg.ff_size, cfg.num_heads,
        cfg.num_layers, 1.0 if clip_sample else 0.0,
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    _build.check(lib, "ddim_sampler", rc)
    ddim_sample_fused.launches += 1
    return out.reshape(b, 1, d)


ddim_sample_fused.launches = 0
