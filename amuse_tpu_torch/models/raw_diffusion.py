"""Legacy raw-pose diffusion denoiser ("diffusion" tag).

Port of ``amuse_tpu/models/raw_diffusion.py`` (the reference's MDM-style
raw baselines, bvh_fac_models.py PoseMDM): a transformer over the pose
sequence itself, no latent VAE. Tokens are [time | content | emotion |
per-frame pose embeddings] (the condition tokens dropped when their
condition is ``None``), learned positions, post-norm encoder layers with
exact GELU, and a projection of the pose tokens back to ``nfeats``.

``cfg.dtype`` is the compute dtype: each block runs over its float32
parameters cast to it, as flax's ``dtype=..., param_dtype=float32``; the
output is float32. The layers drop with ``cfg.dropout`` in training mode,
from the ``generator`` given to ``forward``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from amuse_tpu_torch.models.denoiser import TimestepMLP, timestep_embedding
from amuse_tpu_torch.models.transformer import EncoderLayer, LearnedPositionalEmbedding


@dataclass(frozen=True)
class RawDenoiserConfig:
    nfeats: int = 168  # raw axis-angle + trans pose vector
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    cond_dim: int = 256
    window: int = 300
    dtype: torch.dtype = torch.float32


class RawPoseDenoiser(nn.Module):
    def __init__(self, cfg: RawDenoiserConfig = RawDenoiserConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.pose_embd = nn.Linear(cfg.nfeats, d)
        self.time_mlp = TimestepMLP(d, d)
        self.proj_con = nn.Linear(cfg.cond_dim, d)
        self.proj_emo = nn.Linear(cfg.cond_dim, d)
        self.pos = LearnedPositionalEmbedding(d, cfg.window + 8)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.num_heads, cfg.ff_size, "gelu", False, cfg.dropout)
            for _ in range(cfg.num_layers))
        self.pose_proj = nn.Linear(d, cfg.nfeats)

    def _run(self, module: nn.Module, *args) -> torch.Tensor:
        """``module(*args)`` over its parameters cast to the compute dtype."""
        if self.cfg.dtype == torch.float32:
            return module(*args)
        params = {n: p.to(self.cfg.dtype) for n, p in module.named_parameters()}
        return torch.func.functional_call(module, params, args)

    def forward(self, x_t: torch.Tensor, timesteps: torch.Tensor,
                cond_con: Optional[torch.Tensor] = None,
                cond_emo: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, nfeats) noisy poses, (B,) timesteps, (B, cond_dim) conditions
        -> (B, T, nfeats) float32 prediction."""
        dt = self.cfg.dtype
        h = self._run(self.pose_embd, x_t.to(dt))
        t_sin = timestep_embedding(timesteps, self.cfg.latent_dim).to(dt)
        tokens = [self._run(self.time_mlp, t_sin)[:, None]]
        for proj, cond in ((self.proj_con, cond_con), (self.proj_emo, cond_emo)):
            if cond is not None:
                tokens.append(self._run(proj, cond.to(dt))[:, None])
        n_cond = len(tokens)
        xseq = self.pos(torch.cat(tokens + [h], dim=1))
        for layer in self.layers:
            xseq = self._run(layer, xseq, None, generator)
        return self._run(self.pose_proj, xseq[:, n_cond:]).to(torch.float32)
