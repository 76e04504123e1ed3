"""Legacy CNN audio models (the pre-AST "wav_mfcc" tag).

Port of ``amuse_tpu/models/audio_legacy.py`` (the reference's EVP-style
convolutional disentanglers: audio_main.py EmotionNet, AutoEncoder2x;
_audio_main_new.py AutoEncoder3x). MFCC images (B, T, n_mfcc) go through
conv encoder towers to content, emotion (and style) latents; a conv decoder
reconstructs the MFCCs.

Three of flax's conventions are reproduced: a 3x3 stride-2 'SAME'
convolution pads (0, 1) on an even side and (1, 1) on an odd one; the
encoder head flattens its feature map in channels-last (NHWC) order; and
``ConvTranspose`` is a correlation, kernel not flipped, over the
stride-dilated input, padded (2, 1) at stride 2 and (1, 1) at stride 1.
GELU is flax's default tanh form. ``cfg.dtype`` is the compute dtype of the
convolutions and the dense layers, over float32 parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

KERNEL = 3


@dataclass(frozen=True)
class LegacyAudioConfig:
    in_frames: int = 64
    in_coeffs: int = 28
    channels: int = 64
    latent_dim: int = 128
    num_emotions: int = 8
    num_actors: int = 30
    dtype: torch.dtype = torch.float32


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _same_pads(length: int, stride: int) -> tuple[int, int]:
    """flax 'SAME' padding of a k-3 convolution at ``stride``: (low, high)."""
    out = -(-length // stride)
    total = max((out - 1) * stride + KERNEL - length, 0)
    return total // 2, total - total // 2


def _transpose_pads(stride: int) -> tuple[int, int]:
    """lax.conv_transpose's 'SAME' padding of the dilated input at k 3."""
    pad = KERNEL + stride - 2
    low = KERNEL - 1 if stride > KERNEL - 1 else -(-pad // 2)
    return low, pad - low


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _conv(layer: nn.Conv2d, x: torch.Tensor, stride: tuple[int, int],
          dtype: torch.dtype) -> torch.Tensor:
    """flax 'SAME' convolution of (B, C, H, W) at ``stride``."""
    (ht, hb), (wl, wr) = (_same_pads(n, s) for n, s in zip(x.shape[-2:], stride))
    return F.conv2d(F.pad(x.to(dtype), (wl, wr, ht, hb)), layer.weight.to(dtype),
                    layer.bias.to(dtype), stride=stride)


def _conv_transpose(layer: nn.Conv2d, x: torch.Tensor, stride: tuple[int, int],
                    dtype: torch.dtype) -> torch.Tensor:
    """flax ``ConvTranspose`` ('SAME', unflipped kernel) of (B, C, H, W):
    output side = input side x stride."""
    b, c, h, w = x.shape
    sh, sw = stride
    dilated = x.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1), dtype=dtype)
    dilated[..., ::sh, ::sw] = x.to(dtype)
    (ht, hb), (wl, wr) = _transpose_pads(sh), _transpose_pads(sw)
    return F.conv2d(F.pad(dilated, (wl, wr, ht, hb)), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class ConvEncoder(nn.Module):
    """Three 3x3 stride-2 convs with GELU, then a dense head on the NHWC flatten."""

    def __init__(self, cfg: LegacyAudioConfig, out_dim: int):
        super().__init__()
        self.cfg = cfg
        widths = [1, cfg.channels, cfg.channels * 2, cfg.channels * 4]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, KERNEL) for a, b in zip(widths, widths[1:]))
        h, w = cfg.in_frames, cfg.in_coeffs
        for _ in self.convs:
            h, w = -(-h // 2), -(-w // 2)
        self.head = nn.Linear(h * w * widths[-1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, out_dim) float32."""
        dt = self.cfg.dtype
        h = x[:, None]  # (B, 1, T, C)
        for conv in self.convs:
            h = _gelu(_conv(conv, h, (2, 2), dt))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's NHWC order
        return _linear(self.head, h, dt).float()


class ConvDecoder(nn.Module):
    def __init__(self, cfg: LegacyAudioConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.t0, self.c0 = cfg.in_frames // 8, cfg.in_coeffs // 4
        self.inp = nn.Linear(in_dim, self.t0 * self.c0 * c * 4)
        self.deconvs = nn.ModuleList([nn.Conv2d(c * 4, c * 2, KERNEL),
                                      nn.Conv2d(c * 2, c, KERNEL)])
        self.out = nn.Conv2d(c, 1, KERNEL)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, in_dim) -> (B, in_frames, in_coeffs) float32."""
        dt = self.cfg.dtype
        h = _gelu(_linear(self.inp, z, dt))
        h = h.reshape(z.shape[0], self.t0, self.c0, -1).permute(0, 3, 1, 2)
        for deconv in self.deconvs:
            h = _gelu(_conv_transpose(deconv, h, (2, 2), dt))
        h = _conv_transpose(self.out, h, (2, 1), dt)
        return h[:, 0, :, : self.cfg.in_coeffs].float()


class EmotionNet(nn.Module):
    """MFCC -> emotion latent and its class logits (audio_main.py EmotionNet)."""

    def __init__(self, cfg: LegacyAudioConfig = LegacyAudioConfig()):
        super().__init__()
        self.enc = ConvEncoder(cfg, cfg.latent_dim)
        self.cls = nn.Linear(cfg.latent_dim, cfg.num_emotions)

    def forward(self, mfcc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        z = self.enc(mfcc)
        return z, self.cls(z)


class AutoEncoder2x(nn.Module):
    """Content/emotion two-stream conv AE (audio_main.py AutoEncoder2x)."""

    def __init__(self, cfg: LegacyAudioConfig = LegacyAudioConfig()):
        super().__init__()
        self.con_enc = ConvEncoder(cfg, cfg.latent_dim)
        self.emo_enc = ConvEncoder(cfg, cfg.latent_dim)
        self.dec = ConvDecoder(cfg, 2 * cfg.latent_dim)

    def encode(self, mfcc: torch.Tensor) -> dict:
        return {"con": self.con_enc(mfcc), "emo": self.emo_enc(mfcc)}

    def decode(self, con: torch.Tensor, emo: torch.Tensor) -> torch.Tensor:
        return self.dec(torch.cat([con, emo], dim=-1))

    def forward(self, mfcc: torch.Tensor) -> tuple[torch.Tensor, dict]:
        z = self.encode(mfcc)
        return self.decode(z["con"], z["emo"]), z


class AutoEncoder3x(nn.Module):
    """Content/emotion/style three-stream conv AE (_audio_main_new.py)."""

    def __init__(self, cfg: LegacyAudioConfig = LegacyAudioConfig()):
        super().__init__()
        self.con_enc = ConvEncoder(cfg, cfg.latent_dim)
        self.emo_enc = ConvEncoder(cfg, cfg.latent_dim)
        self.sty_enc = ConvEncoder(cfg, cfg.latent_dim)
        self.dec = ConvDecoder(cfg, 3 * cfg.latent_dim)
        self.emo_cls = nn.Linear(cfg.latent_dim, cfg.num_emotions)
        self.sty_cls = nn.Linear(cfg.latent_dim, cfg.num_actors)

    def encode(self, mfcc: torch.Tensor) -> dict:
        emo, sty = self.emo_enc(mfcc), self.sty_enc(mfcc)
        return {"con": self.con_enc(mfcc), "emo": emo, "sty": sty,
                "emo_logits": self.emo_cls(emo), "sty_logits": self.sty_cls(sty)}

    def decode(self, con: torch.Tensor, emo: torch.Tensor, sty: torch.Tensor) -> torch.Tensor:
        return self.dec(torch.cat([con, emo, sty], dim=-1))

    def forward(self, mfcc: torch.Tensor) -> tuple[torch.Tensor, dict]:
        z = self.encode(mfcc)
        return self.decode(z["con"], z["emo"], z["sty"]), z
