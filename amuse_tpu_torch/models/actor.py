"""ACTOR-style motion transformer AE (reference: Actor_transformers.py).

Port of ``amuse_tpu/models/actor.py``. The final model's paths:

  * encoder: a per-class learned ``mu_query`` token is prepended to the
    skeleton-embedded sequence, sinusoidal positions are added, post-norm
    encoder layers run, and mu is the query token's output;
  * ``ActorAE``: z = mu (no sampling), an MLP head 256 -> 128 -> 64 ->
    classes, cross-entropy; the reconstruction loss is fixed at 0 upstream;
  * decoder: zero time queries plus sinusoidal positions cross-attend the
    single latent token, with no action-bias shift; ``ActorAE.decode``.

The layers drop with ``cfg.dropout`` in training mode, from the
``generator`` given to ``forward``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from amuse_tpu_torch.models.transformer import DecoderLayer, EncoderLayer, dropout


@dataclass(frozen=True)
class ActorConfig:
    njoints: int = 47
    nfeats: int = 6
    num_frames: int = 300
    num_classes: int = 8  # 8 emotions (or 30 personalities upstream)
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Vaswani's table (reference PositionalEncoding), (length, dim) float32."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe.astype(np.float32)


def _positions(length: int, dim: int, device) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_positions(length, dim)).to(device)


class ActorEncoder(nn.Module):
    """(B, T, J*F) motion and (B,) class -> mu (B, latent_dim)."""

    def __init__(self, cfg: ActorConfig = ActorConfig()):
        super().__init__()
        self.cfg = cfg
        self.skel_embedding = nn.Linear(cfg.input_feats, cfg.latent_dim)
        self.mu_query = nn.Parameter(torch.randn(cfg.num_classes, cfg.latent_dim))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.latent_dim, cfg.num_heads, cfg.ff_size, cfg.activation, False,
                         cfg.dropout) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        seq = torch.cat([self.mu_query[y][:, None], self.skel_embedding(x)], dim=1)
        seq = seq + _positions(seq.shape[1], cfg.latent_dim, seq.device)
        seq = dropout(seq, cfg.dropout, self.training, generator)
        for layer in self.layers:
            seq = layer(seq, None, generator)
        return seq[:, 0]


class ActorDecoder(nn.Module):
    """latent (B, D) -> motion (B, T, J*F) through zero time queries."""

    def __init__(self, cfg: ActorConfig = ActorConfig()):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DecoderLayer(cfg.latent_dim, cfg.num_heads, cfg.ff_size, cfg.activation, False,
                         cfg.dropout) for _ in range(cfg.num_layers))
        self.final = nn.Linear(cfg.latent_dim, cfg.input_feats)

    def forward(self, z: torch.Tensor, nframes: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        t = nframes or cfg.num_frames
        queries = _positions(t, cfg.latent_dim, z.device).expand(z.shape[0], t, cfg.latent_dim)
        h = dropout(queries.to(z.dtype), cfg.dropout, self.training, generator)
        memory = z[:, None, :]  # a single latent token; no action bias shift
        for layer in self.layers:
            h = layer(h, memory, None, None, generator)
        return self.final(h)


class ActorAE(nn.Module):
    """The reference ACTOR_AE: encode -> z = mu -> classify; recon disabled."""

    def __init__(self, cfg: ActorConfig = ActorConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = ActorEncoder(cfg)
        self.decoder = ActorDecoder(cfg)
        self.cls_fc1 = nn.Linear(cfg.latent_dim, 128)
        self.cls_fc2 = nn.Linear(128, 64)
        self.cls_out = nn.Linear(64, cfg.num_classes)

    def classify(self, z: torch.Tensor) -> torch.Tensor:
        return self.cls_out(F.relu(self.cls_fc2(F.relu(self.cls_fc1(z)))))

    def decode(self, z: torch.Tensor, nframes: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder(z, nframes, generator)

    def forward(self, x: torch.Tensor, emo_label: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        z = self.encoder(x, emo_label, generator)
        logits = self.classify(z)
        return {
            "z": z,
            "predicted_labels": logits,
            "prediction": torch.softmax(logits, dim=-1),
            "recon_loss": torch.zeros((), device=z.device),  # upstream fixes it at 0
            "class_loss": F.cross_entropy(logits, emo_label),
        }
