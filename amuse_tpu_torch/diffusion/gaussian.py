"""Gaussian diffusion toolkit of the raw-pose baseline ("diffusion" tag).

Port of ``amuse_tpu/diffusion/gaussian.py`` (the reference's vendored OpenAI
stack: mdm_gaussian_diffusion.py, mdm_respace.py, mdm_resample.py):

  * beta schedules: linear (scaled to the timestep count) and cosine; the
    tables are built in float64 numpy and stored float32, so they equal the
    JAX package's bit for bit;
  * q(x_t | x_0), the true posterior mean, and the per-sample training loss
    for x0- and epsilon-prediction;
  * ancestral DDPM sampling and respaced eta=0 DDIM sampling as Python loops
    over the steps (the JAX package's ``lax.scan``);
  * loss-aware timestep sampling (running second moments of the per-timestep
    losses) as a state that ``loss_aware_update`` replaces.

Every draw takes an explicit ``torch.Generator`` or an injected tensor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# model_fn(x_t (B, ...), t (B,) int64) -> prediction of x_0 or of epsilon
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def linear_betas(num_timesteps: int, scale_ref: int = 1000) -> np.ndarray:
    """OpenAI 'linear' schedule, scaled so any T matches the 1000-step shape."""
    scale = scale_ref / num_timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, num_timesteps, dtype=np.float64)


def cosine_betas(num_timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    betas = 1.0 - f[1:] / f[:-1]
    return np.clip(betas, 0.0, 0.999)


class GaussianDiffusion(NamedTuple):
    """float32 tables of length T, on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_gaussian_diffusion(betas: np.ndarray,
                            device: str | torch.device = "cpu") -> GaussianDiffusion:
    betas = np.asarray(betas, np.float64)
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    post_logvar = np.log(np.concatenate([[post_var[1]], post_var[1:]]))
    coef1 = betas * np.sqrt(acp_prev) / (1.0 - acp)
    coef2 = (1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp)
    return GaussianDiffusion(*(torch.from_numpy(x.astype(np.float32)).to(device) for x in (
        betas, acp, acp_prev, post_var, post_logvar, coef1, coef2)))


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    return table[t].reshape(t.shape + (1,) * (ndim - t.ndim))


def q_sample(gd: GaussianDiffusion, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    acp = _extract(gd.alphas_cumprod, t, x0.ndim)
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def predict_x0_from_eps(gd: GaussianDiffusion, x_t: torch.Tensor, t: torch.Tensor,
                        eps: torch.Tensor) -> torch.Tensor:
    acp = _extract(gd.alphas_cumprod, t, x_t.ndim)
    return (x_t - torch.sqrt(1.0 - acp) * eps) / torch.sqrt(acp)


def q_posterior_mean(gd: GaussianDiffusion, x0: torch.Tensor, x_t: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    c1 = _extract(gd.posterior_mean_coef1, t, x0.ndim)
    c2 = _extract(gd.posterior_mean_coef2, t, x0.ndim)
    return c1 * x0 + c2 * x_t


def training_loss(gd: GaussianDiffusion, model_fn: ModelFn, x0: torch.Tensor,
                  t: torch.Tensor, noise: torch.Tensor,
                  predict: str = "x0") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample MSE losses (B,) and their mean; ``noise`` is epsilon (x0's shape)."""
    x_t = q_sample(gd, x0, t, noise)
    pred = model_fn(x_t, t)
    target = x0 if predict == "x0" else noise
    per_sample = torch.mean((pred - target) ** 2, dim=tuple(range(1, x0.ndim)))
    return per_sample, torch.mean(per_sample)


def _normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def p_sample_loop(gd: GaussianDiffusion, model_fn: ModelFn, shape: tuple[int, ...],
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None, predict: str = "x0",
                  clip_x0: bool = False) -> torch.Tensor:
    """Ancestral DDPM sampling over all T steps, t = T-1 down to 0.

    ``noise`` (T + 1, *shape): row 0 is x_T, row 1 + k the noise of the k-th
    step, as the JAX package draws them (it draws the last row too and
    multiplies it by 0); without it each is drawn from ``generator`` on the
    tables' device.
    """
    dev = gd.betas.device
    x = noise[0] if noise is not None else _normal(shape, generator, dev)
    for k, t in enumerate(range(gd.num_timesteps - 1, -1, -1)):
        tt = torch.full((shape[0],), t, dtype=torch.long, device=dev)
        pred = model_fn(x, tt)
        x0 = pred if predict == "x0" else predict_x0_from_eps(gd, x, tt, pred)
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
        x = q_posterior_mean(gd, x0, x, tt)
        if t > 0:
            z = noise[1 + k] if noise is not None else _normal(shape, generator, dev)
            x = x + torch.exp(0.5 * gd.posterior_log_variance_clipped[t]) * z
    return x


def respaced_timesteps(num_timesteps: int, sections: int) -> np.ndarray:
    """Evenly respaced subset (mdm_respace.space_timesteps, one 'uniform'
    section): the fractional stride (T-1)/(count-1) accumulated and rounded,
    so the final timestep T-1 is always included."""
    if sections <= 1:
        return np.zeros(max(sections, 0), np.int64)
    frac = (num_timesteps - 1) / (sections - 1)
    return np.asarray([round(i * frac) for i in range(sections)], np.int64)


def ddim_sample_loop(gd: GaussianDiffusion, model_fn: ModelFn, shape: tuple[int, ...],
                     num_steps: int = 50, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     predict: str = "x0") -> torch.Tensor:
    """Respaced eta=0 DDIM over this diffusion's tables from x_T = ``noise``
    (``shape``), drawn from ``generator`` when not given."""
    dev = gd.betas.device
    ts = respaced_timesteps(gd.num_timesteps, num_steps)[::-1].tolist()
    x = noise if noise is not None else _normal(shape, generator, dev)
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        tt = torch.full((shape[0],), t, dtype=torch.long, device=dev)
        pred = model_fn(x, tt)
        if predict == "x0":
            x0 = pred
            acp_t = gd.alphas_cumprod[t]
            eps = (x - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
        else:
            eps = pred
            x0 = predict_x0_from_eps(gd, x, tt, eps)
        acp_prev = (gd.alphas_cumprod[t_prev] if t_prev >= 0
                    else torch.ones((), device=dev))
        x = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps
    return x


# --------------------------------------------------- loss-aware resampling


class LossAwareState(NamedTuple):
    """Running second moments of per-timestep losses (mdm_resample.py)."""

    loss_sq_history: torch.Tensor  # (T, K) float32: the last K squared losses per timestep
    counts: torch.Tensor  # (T,) int64: losses seen per timestep

    @classmethod
    def create(cls, num_timesteps: int, history: int = 10,
               device: str | torch.device = "cpu") -> "LossAwareState":
        return cls(torch.zeros((num_timesteps, history), device=device),
                   torch.zeros(num_timesteps, dtype=torch.long, device=device))


def loss_aware_weights(state: LossAwareState, uniform_prob: float = 0.001) -> torch.Tensor:
    """Sampling probabilities proportional to the RMS loss once every timestep
    holds K losses, uniform before."""
    hist = state.loss_sq_history
    warm = torch.all(state.counts >= hist.shape[1])
    rms = torch.sqrt(torch.mean(hist, dim=1) + 1e-12)
    p = rms / torch.sum(rms)
    p = p * (1 - uniform_prob) + uniform_prob / p.shape[0]
    return torch.where(warm, p, torch.full_like(p, 1.0 / p.shape[0]))


def loss_aware_update(state: LossAwareState, t: torch.Tensor,
                      losses: torch.Tensor) -> LossAwareState:
    """Insert the batch's squared losses into each timestep's ring in batch order.

    The JAX package scans the batch one sample at a time: a timestep's ring
    is appended to until it holds K values, then shifted left once per new
    value. The result of that scan for a row that held ``m`` = min(count, K)
    values and receives ``n`` new ones is the last K entries of the sequence
    (its m values, then the n new ones in batch order), or, while that
    sequence is shorter than K, the sequence followed by the row's untouched
    tail. This computes it for every row at once: each sample's rank among
    the earlier samples of its timestep places it, so repeated timesteps keep
    the batch order. No value is rounded on the way: the rows equal the
    scan's bit for bit.
    """
    hist, counts = state
    n_t, k = hist.shape
    b = t.shape[0]
    sq = (losses ** 2).to(hist.dtype)
    same = t[:, None] == t[None, :]
    rank = torch.sum(torch.tril(same, diagonal=-1), dim=1)  # earlier samples at my t
    new = torch.zeros((n_t, b), dtype=hist.dtype, device=hist.device)
    new[t, rank] = sq
    added = torch.zeros_like(counts).index_add_(0, t, torch.ones_like(t))
    m = torch.clamp(counts, max=k)
    length = m + added  # the sequence's length per row
    src = torch.clamp(length - k, min=0)[:, None] + torch.arange(k, device=hist.device)
    from_new = (src >= m[:, None]) & (src < length[:, None])
    old = torch.gather(hist, 1, torch.clamp(src, max=k - 1))
    fresh = torch.gather(new, 1, torch.clamp(src - m[:, None], 0, b - 1))
    return LossAwareState(torch.where(from_new, fresh, old), counts + added)


def sample_timesteps(state: LossAwareState, batch: int,
                     generator: Optional[torch.Generator] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample timesteps -> (t (B,) int64, weights 1 / (T p_t))."""
    p = loss_aware_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])
