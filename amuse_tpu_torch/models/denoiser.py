"""Latent diffusion denoiser: epsilon-predictor over the motion latent.

Port of ``amuse_tpu/models/denoiser.py`` (reference ``Denoiser``,
``trans_enc`` + skip-connection arch):

  token sequence = [ noisy latent (1) | time (1) | content (1) |
                     emotion (1) | style (1) ]  ->  9-layer skip-transformer
  prediction     = output token 0

The emotion/style tokens are dropped when their condition is ``None``, so
the sequence holds 3 to 5 tokens. Parameter names are the reference keys
(``time_embedding.linear_{1,2}``, ``emb_proj_{con,emo,sty}.1``,
``query_pos.pe``, ``encoder.*``). The encoder's layers drop with
``cfg.dropout`` in training mode only, from the ``generator`` given to
``forward``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from amuse_tpu_torch.models.transformer import LearnedPositionalEmbedding, SkipEncoder


@dataclass(frozen=True)
class DenoiserConfig:
    latent_tokens: int = 1
    latent_dim: int = 128
    ff_size: int = 512
    num_layers: int = 9
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    normalize_before: bool = False
    cond_dim: int = 256
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    max_len: int = 500


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10_000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers semantics), (B,) -> (B, dim) float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepMLP(nn.Module):
    """Linear -> SiLU -> Linear."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class CondProj(nn.Sequential):
    """ReLU -> Linear conditioning projection (keys ``1.weight``/``1.bias``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.ReLU(), nn.Linear(in_dim, out_dim))


class Denoiser(nn.Module):
    def __init__(self, cfg: DenoiserConfig = DenoiserConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.time_embedding = TimestepMLP(cfg.cond_dim, d)
        self.emb_proj_con = CondProj(cfg.cond_dim, d)
        self.emb_proj_emo = CondProj(cfg.cond_dim, d)
        self.emb_proj_sty = CondProj(cfg.cond_dim, d)
        self.query_pos = LearnedPositionalEmbedding(d, cfg.max_len)
        self.encoder = SkipEncoder(d, cfg.num_heads, cfg.ff_size, cfg.num_layers,
                                   cfg.activation, cfg.normalize_before, cfg.dropout)

    def time_tokens(self, timesteps: torch.Tensor) -> torch.Tensor:
        """(B,) int timesteps -> (B, latent_dim) time tokens (before positions)."""
        cfg = self.cfg
        t_sin = timestep_embedding(timesteps, cfg.cond_dim, cfg.flip_sin_to_cos, cfg.freq_shift)
        return self.time_embedding(t_sin)

    def cond_tokens(self, cond_con: torch.Tensor, cond_emo: Optional[torch.Tensor] = None,
                    cond_sty: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
        """The (B, latent_dim) condition tokens in sequence order, None streams dropped."""
        pairs = ((self.emb_proj_con, cond_con), (self.emb_proj_emo, cond_emo),
                 (self.emb_proj_sty, cond_sty))
        return [proj(c.to(torch.float32)) for proj, c in pairs if c is not None]

    def forward(
        self,
        sample: torch.Tensor,  # (B, latent_tokens, latent_dim) noisy latent
        timesteps: torch.Tensor | int,  # (B,), scalar tensor or int
        cond_con: torch.Tensor,  # (B, cond_dim)
        cond_emo: Optional[torch.Tensor] = None,
        cond_sty: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(b)
        tokens = [sample.to(torch.float32), self.time_tokens(timesteps)[:, None, :]]
        tokens += [tok[:, None, :] for tok in self.cond_tokens(cond_con, cond_emo, cond_sty)]
        xseq = self.query_pos(torch.cat(tokens, dim=1))  # (B, 3..5, D)
        out = self.encoder(xseq, None, generator)
        return out[:, : self.cfg.latent_tokens].to(torch.float32)
