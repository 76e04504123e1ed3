"""Motion prior: transformer VAE over 300-frame SMPL-X pose windows.

Port of ``amuse_tpu/models/vae.py`` (reference ``MotionPrior``): the encoder
prepends two learned distribution tokens whose outputs are mu and logvar;
the decoder's queries are zero vectors + learned positions cross-attending
the latent token. Parameter names are the reference keys
(``skel_embedding``, ``global_motion_token``, ``query_pos_encoder.pe``,
``query_pos_decoder.pe``, ``encoder.*``, ``decoder.*``, ``final_layer``).
Every layer drops with ``cfg.dropout`` in training mode only, its masks
drawn from the ``generator`` given to ``encode``/``decode``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from amuse_tpu_torch.models.transformer import (
    LearnedPositionalEmbedding,
    SkipDecoder,
    SkipEncoder,
    lengths_to_mask,
)


@dataclass(frozen=True)
class PriorConfig:
    nfeats: int = 333  # 55 joints x 6D + translation
    latent_tokens: int = 1
    latent_dim: int = 128
    ff_size: int = 512
    num_layers: int = 9
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    normalize_before: bool = False
    window: int = 300
    max_len: int = 500


class MotionPrior(nn.Module):
    def __init__(self, cfg: PriorConfig = PriorConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.skel_embedding = nn.Linear(cfg.nfeats, d)
        self.global_motion_token = nn.Parameter(torch.randn(2 * cfg.latent_tokens, d))
        self.query_pos_encoder = LearnedPositionalEmbedding(d, cfg.max_len)
        self.query_pos_decoder = LearnedPositionalEmbedding(d, cfg.max_len)
        args = (d, cfg.num_heads, cfg.ff_size, cfg.num_layers, cfg.activation,
                cfg.normalize_before, cfg.dropout)
        self.encoder = SkipEncoder(*args)
        self.decoder = SkipDecoder(*args)
        self.final_layer = nn.Linear(d, cfg.nfeats)

    def encode_params(self, features: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """(B, T, nfeats) -> (mu, logvar), each (B, latent_tokens, latent_dim) float32."""
        cfg = self.cfg
        b, t, _ = features.shape
        x = self.skel_embedding(features)
        tokens = self.global_motion_token[None].to(x.dtype).expand(b, -1, -1)
        xseq = self.query_pos_encoder(torch.cat([tokens, x], dim=1))
        mask = lengths_to_mask(lengths, t)
        if mask is not None:
            keep = torch.ones((b, 2 * cfg.latent_tokens), dtype=torch.bool, device=mask.device)
            mask = torch.cat([keep, mask], dim=1)
        out = self.encoder(xseq, mask, generator)
        mu = out[:, : cfg.latent_tokens]
        logvar = out[:, cfg.latent_tokens : 2 * cfg.latent_tokens]
        return mu.to(torch.float32), logvar.to(torch.float32)

    def encode(self, features: torch.Tensor, generator: Optional[torch.Generator] = None,
               lengths: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """Reparameterised sample z = mu + exp(0.5 logvar) * eps -> (z, (mu, logvar)).

        ``noise`` replaces the N(0, 1) draw from ``generator``.
        """
        mu, logvar = self.encode_params(features, lengths, generator)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        return mu + torch.exp(0.5 * logvar) * noise, (mu, logvar)

    def decode(self, z: torch.Tensor, frames: Optional[int] = None,
               lengths: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, latent_tokens, latent_dim) -> (B, frames, nfeats) float32."""
        cfg = self.cfg
        t = frames if frames is not None else cfg.window
        queries = self.query_pos_decoder(
            torch.zeros((z.shape[0], t, cfg.latent_dim), dtype=z.dtype, device=z.device)
        )
        mask = lengths_to_mask(lengths, t)
        feats = self.final_layer(self.decoder(queries, z, mask, generator))
        if mask is not None:
            feats = torch.where(mask[..., None], feats, torch.zeros_like(feats))
        return feats.to(torch.float32)


def kl_divergence_normal(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Mean KL(q || N(0, 1)): 0.5 * (mu^2 + var - 1 - logvar), averaged."""
    return torch.mean(0.5 * (mu**2 + torch.exp(logvar) - 1.0 - logvar))
