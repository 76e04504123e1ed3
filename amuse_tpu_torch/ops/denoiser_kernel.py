"""The whole-loop DDIM sampler: kernel K3 and its plain version.

``ddim_sample_fused`` runs the eta=0 DDIM loop of the latent denoiser. For
CUDA tensors it launches the hand-written Hopper kernel
``csrc/ddim_sampler.cu`` once for all steps, one thread-block cluster per
window (it replaces the TPU kernel
``amuse_tpu/ops/denoiser_kernel.py::_sampler_kernel``; its source note gives
the bound and the design). For CPU tensors it runs the plain version,
``ddim_sample_reference``: the Python DDIM loop over the torch ``Denoiser``.
There is no fallback: an unsupported CUDA input raises.
``ddim_sample_fused.launches`` counts kernel launches.

As in the JAX package, the latent-independent parts are computed outside
the kernel in torch, in two parts: ``schedule_conditioning`` (per weights,
schedule and step count: the time tokens with pos[1] folded in, the per-step
DDIM coefficients c0..c3, equal to ``ddim_step``'s including
alphas_cumprod[0] on the last step, and pos[0]), which callers that sample
repeatedly compute once, and ``condition_tokens`` (per call).
``pack_for_cluster`` lays the weights out as the kernel reads them: for each
CTA of the cluster one contiguous run of its slices, in reading order;
``SamplerWeights`` keeps those runs for each cluster size ``cluster_for``
picks (8 CTAs per window while all windows fit the card at once).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from amuse_tpu_torch.diffusion.sampler import ddim_sample
from amuse_tpu_torch.diffusion.schedulers import (
    DiffusionSchedule,
    ddim_coefficient_table,
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

    def skip(fn, shape):  # an empty stack where one layer has no skip merge
        return torch.stack([fn(lin).detach().float() for lin in enc.linear_blocks]
                           or [torch.zeros(shape, device=enc.norm.weight.device)])[:len(enc.linear_blocks)].contiguous()

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
        wskip=skip(lambda lin: lin.weight.T, (2 * d, d)),
        bskip=skip(lambda lin: lin.bias, (d,)),
        final_scale=enc.norm.weight.detach().float().clone(),
        final_bias=enc.norm.bias.detach().float().clone(),
    )


# Cluster sizes the kernel is launched with, largest first: one window runs
# on C CTAs, and C must divide d and ff into groups of 4 columns. 8 is the
# portable maximum.
CLUSTER_SIZES = (8, 4, 2, 1)


class Segment(NamedTuple):
    """One piece of a CTA's weight run: ``rows`` x ``cols`` float32, row-major."""

    kind: str  # merge, qkv, o, ln1, ff1, ff2, ln2, final
    index: int  # the layer; for a merge, the skip merge's index
    rows: int
    cols: int


def stream_segments(d: int, ff: int, layers: int, cluster: int) -> list[Segment]:
    """The segments of one CTA's weight run for one step, in the order the
    kernel reads them (csrc/ddim_sampler.cu, ``seg_kind``/``seg_shape``).
    A matrix slice's last row is its bias slice."""
    dc, fc, n_skip = d // cluster, ff // cluster, (layers - 1) // 2
    segs = []
    for layer in range(layers):
        if layer > n_skip:
            segs.append(Segment("merge", layer - n_skip - 1, 2 * d + 1, dc))
        segs += [Segment("qkv", layer, d + 1, 3 * dc), Segment("o", layer, d + 1, dc),
                 Segment("ln1", layer, 2, d), Segment("ff1", layer, d + 1, fc),
                 Segment("ff2", layer, fc, d), Segment("ln2", layer, 3, d)]
    return segs + [Segment("final", 0, 2, d)]


def _segment(p: PackedDenoiser, seg: Segment, c: int, cluster: int) -> torch.Tensor:
    """CTA c's (rows, cols) piece of ``seg``."""
    d, ff = p.wq.shape[1], p.w1.shape[2]
    cs = slice(c * d // cluster, (c + 1) * d // cluster)
    fs = slice(c * ff // cluster, (c + 1) * ff // cluster)
    i = seg.index

    def with_bias(w, b):
        return torch.cat([w, b[None]])

    if seg.kind == "merge":
        return with_bias(p.wskip[i][:, cs], p.bskip[i][cs])
    if seg.kind == "qkv":
        return with_bias(torch.cat([p.wq[i][:, cs], p.wk[i][:, cs], p.wv[i][:, cs]], dim=1),
                         torch.cat([p.bq[i][cs], p.bk[i][cs], p.bv[i][cs]]))
    if seg.kind == "o":
        return with_bias(p.wo[i][:, cs], p.bo[i][cs])
    if seg.kind == "ln1":
        return torch.stack([p.ln_scale[i, 0], p.ln_bias[i, 0]])
    if seg.kind == "ff1":
        return with_bias(p.w1[i][:, fs], p.b1[i][fs])
    if seg.kind == "ff2":
        return p.w2[i][fs, :]
    if seg.kind == "ln2":
        return torch.stack([p.b2[i], p.ln_scale[i, 1], p.ln_bias[i, 1]])
    return torch.stack([p.final_scale, p.final_bias])


class ClusterPack(NamedTuple):
    """The kernel's weights: ``weights[c]`` is CTA c's run for one step
    (``stream_segments`` order), float32, contiguous."""

    weights: torch.Tensor  # (cluster, step_floats)
    cluster: int


@torch.no_grad()
def pack_for_cluster(packed: PackedDenoiser, cluster: int) -> ClusterPack:
    """``pack_denoiser``'s weights -> one contiguous run per CTA of a cluster,
    so that one bulk copy fetches a CTA's share of a layer's matrix. Plain
    torch, once per set of weights and cluster size."""
    d, layers, ff = packed.wq.shape[1], packed.wq.shape[0], packed.w1.shape[2]
    if d % (4 * cluster) or ff % (4 * cluster):
        raise ValueError(f"a cluster of {cluster} needs d and ff in multiples of {4 * cluster}")
    segs = stream_segments(d, ff, layers, cluster)
    runs = [torch.cat([_segment(packed, seg, c, cluster).reshape(-1) for seg in segs])
            for c in range(cluster)]
    return ClusterPack(torch.stack(runs).contiguous(), cluster)


class SamplerWeights:
    """``pack_denoiser``'s weights and their runs for each cluster size the
    kernel launches with, each packed once, at its first use."""

    def __init__(self, packed: PackedDenoiser):
        self.packed = packed
        self._runs: dict[int, ClusterPack] = {}

    def for_cluster(self, cluster: int) -> ClusterPack:
        if cluster not in self._runs:
            self._runs[cluster] = pack_for_cluster(self.packed, cluster)
        return self._runs[cluster]


class ScheduleConditioning(NamedTuple):
    """The latent- and condition-independent kernel inputs (float32)."""

    time_tokens: torch.Tensor  # (steps, D), pos[1] folded in
    coeffs: torch.Tensor  # (steps, 4): c0..c3 of each DDIM step
    pos0: torch.Tensor  # (D,)


@torch.no_grad()
def schedule_conditioning(denoiser: Denoiser, schedule: DiffusionSchedule,
                          num_steps: int = 50) -> ScheduleConditioning:
    """The per-schedule part of the conditioning, on the denoiser's device."""
    device = denoiser.query_pos.pe.device
    ts = ddim_timesteps(schedule, num_steps)
    pe = denoiser.query_pos.pe.detach()[:, 0].float()  # (max_len, D)
    time_tokens = denoiser.time_tokens(ts.to(device)) + pe[1]
    coeffs = ddim_coefficient_table(schedule, num_steps)
    return ScheduleConditioning(time_tokens.contiguous(), coeffs.to(device).contiguous(),
                                pe[0].contiguous())


@torch.no_grad()
def condition_tokens(denoiser: Denoiser, con: torch.Tensor, emo: Optional[torch.Tensor] = None,
                     sty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-call part: (B, n_cond, D) condition tokens with their positions."""
    pe = denoiser.query_pos.pe.detach()[:, 0].float()
    cond_list = denoiser.cond_tokens(con, emo, sty)
    return (torch.stack(cond_list, dim=1) + pe[2 : 2 + len(cond_list)]).contiguous()


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
    all float32: ``schedule_conditioning`` and ``condition_tokens`` together."""
    sched = schedule_conditioning(denoiser, schedule, num_steps)
    return (sched.time_tokens, condition_tokens(denoiser, con, emo, sty), sched.coeffs,
            sched.pos0)


@torch.no_grad()
def ddim_sample_reference(
    denoiser: Denoiser,
    schedule: DiffusionSchedule,
    con: Optional[torch.Tensor],
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
    packed: Optional[SamplerWeights] = None,
    conditioning: Optional[ScheduleConditioning] = None,
) -> torch.Tensor:
    """Sample motion latents (B, latent_tokens, D) float32 by eta=0 DDIM.

    Initial latents come from ``initial_latents`` or from a N(0, 1) draw of
    ``generator`` on ``con``'s device. ``packed`` (``SamplerWeights``) and
    ``conditioning`` (``schedule_conditioning`` for ``num_steps``) are kept
    by callers that sample repeatedly; the CUDA path builds what is not
    given, and launches at the cluster size ``cluster_for`` picks for B.
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
    _check_denoiser(cfg)
    if any(p.device != device for p in denoiser.parameters()):
        raise ValueError("the denoiser must lie on the conditions' device")
    if packed is None:
        packed = SamplerWeights(pack_denoiser(denoiser))
    if conditioning is None:
        conditioning = schedule_conditioning(denoiser, schedule, num_steps)
    if conditioning.time_tokens.shape[0] != num_steps:
        raise ValueError(f"conditioning holds {conditioning.time_tokens.shape[0]} steps, "
                         f"not num_steps={num_steps}")
    return launch_sampler(packed.for_cluster(cluster_for(cfg, b)), conditioning,
                          condition_tokens(denoiser, con, emo, sty), x0, cfg, clip_sample)


def _check_denoiser(cfg: DenoiserConfig) -> None:
    if cfg.latent_tokens != 1:
        raise ValueError(f"the sampler kernel takes one latent token, got {cfg.latent_tokens}")
    if cfg.activation != "gelu" or cfg.normalize_before:
        raise ValueError("the sampler kernel runs post-norm GELU layers only")
    # and, as sampler_plan checks, activations that fit in shared memory
    if cfg.latent_dim % 4 or cfg.ff_size % 4 or max(cfg.latent_dim, cfg.ff_size) > 2048:
        raise ValueError("the sampler kernel takes latent_dim and ff_size in multiples "
                         "of 4, at most 2048")


@functools.lru_cache(maxsize=None)
def _plan(d: int, ff: int, heads: int, layers: int, cluster: int) -> tuple:
    """(the kernel's launch plan at these dims, "") or (None, why the kernel
    does not take them at this cluster size)."""
    lib = _build.load("ddim_sampler")
    lib.ddim_sampler_plan.restype = ctypes.c_char_p
    lib.ddim_sampler_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    info = (ctypes.c_longlong * 5)()
    why = lib.ddim_sampler_plan(d, ff, heads, layers, cluster, ctypes.addressof(info))
    if why is not None:
        return None, why.decode()
    count = ctypes.c_int(0)
    lib.ddim_sampler_max_clusters.restype = ctypes.c_int
    lib.ddim_sampler_max_clusters.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    _build.check(lib, "ddim_sampler_max_clusters", lib.ddim_sampler_max_clusters(
        d, ff, heads, layers, cluster, ctypes.addressof(count)))
    return {"cluster": cluster, "smem_bytes": info[0], "ring_bytes": info[1],
            "chunks_per_step": info[2], "step_floats": info[3], "scratch_bytes": info[4],
            "max_active_clusters": count.value}, ""


def sampler_plan(d: int, ff: int, heads: int, layers: int, cluster: int) -> dict:
    """The kernel's launch plan at these dims (shared memory, weight ring,
    chunks per step, split-K scratch, clusters the card runs at once). Raises
    where the kernel does not take the dims or the card cannot run a cluster
    of that size."""
    plan, why = _plan(d, ff, heads, layers, cluster)
    if plan is None:
        raise ValueError(f"the sampler kernel does not take d={d}, ff={ff}, heads={heads}, "
                         f"layers={layers} on a cluster of {cluster}: {why}")
    if plan["max_active_clusters"] < 1:
        raise RuntimeError(f"the card cannot run a cluster of {cluster} CTAs with "
                           f"{plan['smem_bytes']} bytes of shared memory each "
                           f"(cudaOccupancyMaxActiveClusters = 0)")
    return plan


def cluster_for(cfg: DenoiserConfig, batch: int) -> int:
    """The largest cluster size at which the card runs all ``batch`` windows
    at once (cudaOccupancyMaxActiveClusters), else the size that runs the
    most at once: the chain of one window is latency-bound, so a wave of
    smaller clusters beats two waves of large ones. Raises, with the largest
    size's reason, where no size takes the dims."""
    dims = (cfg.latent_dim, cfg.ff_size, cfg.num_heads, cfg.num_layers)
    plans = [_plan(*dims, c)[0] for c in CLUSTER_SIZES]
    runnable = [p for p in plans if p is not None and p["max_active_clusters"] >= 1]
    if not runnable:
        sampler_plan(*dims, CLUSTER_SIZES[0])
    fits = [p for p in runnable if p["max_active_clusters"] >= batch]
    best = fits[0] if fits else max(runnable, key=lambda p: p["max_active_clusters"])
    return best["cluster"]


def launch_sampler(packed: ClusterPack, conditioning: ScheduleConditioning, cond: torch.Tensor,
                   x0: torch.Tensor, cfg: DenoiserConfig, clip_sample: bool = True,
                   stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the sampler kernel on CUDA inputs: ``cond`` the (B,
    n_cond, D) condition tokens (n_cond 0..3), ``x0`` the (B, 1, D) initial
    latents. ``stats``, an int32 tensor of 3 on the same device, receives
    what the first CTA passed: cluster barriers, exchanges and block
    barriers. Exposed so that a measurement can time the kernel without what
    precedes it and count its barriers."""
    b, d = x0.shape[0], cfg.latent_dim
    if cond.dim() != 3 or cond.shape[0] != b or cond.shape[2] != d:
        raise ValueError(f"cond must be ({b}, n_cond, {d}), got {tuple(cond.shape)}")
    if 2 + cond.shape[1] > MAX_REAL_TOKENS:
        raise ValueError(f"the sampler kernel takes at most {MAX_REAL_TOKENS} tokens")
    tensors = (*conditioning, cond, x0, packed.weights)
    if any(t.device != x0.device or t.dtype != torch.float32 for t in tensors):
        raise ValueError("the sampler kernel's inputs must be float32 on one CUDA device")
    plan = sampler_plan(d, cfg.ff_size, cfg.num_heads, cfg.num_layers, packed.cluster)
    if tuple(packed.weights.shape) != (packed.cluster, plan["step_floats"]):
        raise ValueError(f"packed weights {tuple(packed.weights.shape)} do not match the "
                         f"plan's ({packed.cluster}, {plan['step_floats']})")
    time_tokens, coeffs, pos0 = (t.contiguous() for t in conditioning)
    cond, weights = cond.contiguous(), packed.weights.contiguous()
    x0 = x0.reshape(b, d).contiguous()
    if stats is not None and (stats.dtype != torch.int32 or stats.numel() != 3
                              or stats.device != x0.device or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous int32 tensor of 3 on the inputs' device")
    out = torch.empty((b, d), dtype=torch.float32, device=x0.device)
    lib = _build.load("ddim_sampler")
    fn = lib.ddim_sampler
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(
        time_tokens.data_ptr(), cond.data_ptr(), coeffs.data_ptr(), pos0.data_ptr(),
        x0.data_ptr(), weights.data_ptr(), out.data_ptr(), weights.numel(),
        b, 2 + cond.shape[1], time_tokens.shape[0], d, cfg.ff_size, cfg.num_heads,
        cfg.num_layers, packed.cluster, 1.0 if clip_sample else 0.0,
        None if stats is None else stats.data_ptr(), torch.cuda.current_stream(x0.device).cuda_stream,
    )
    _build.check(lib, "ddim_sampler", rc)
    ddim_sample_fused.launches += 1
    return out.reshape(b, 1, d)


ddim_sample_fused.launches = 0
