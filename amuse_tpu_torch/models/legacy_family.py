"""Legacy "diffusion"-tag model family: the CaMN/MDM-era members.

Port of ``amuse_tpu/models/legacy_family.py`` (the reference's
bvh_fac_models.py "lstm" and "trans_face_dec" arches, txt_models.py,
txt_util.py, fac_util.py, wav_models.py, fusion_addon.py,
discriminator.py). No reference CLI task reaches this family; it is kept
for the model zoo.

Sequences are (B, T, C), channels last, as in the JAX package; the
convolutions transpose to torch's (B, C, T) around each call. Where flax
and torch differ, flax's behaviour is kept:

  * ``BatchNorm`` (momentum 0.9, eps 1e-5) reduces over (B, T); in
    training mode it normalises with the batch mean and the biased batch
    variance and moves the running statistics towards those, the biased
    variance included. The variance is computed in two passes, not as
    flax's E[x^2] - E[x]^2, which loses the variance in float32 when a
    channel's mean is large against its spread (30% at mean 1000, spread 1);
    the two agree to rounding elsewhere;
  * the stacked LSTM is ``torch.nn.LSTM`` with flax's gate order (i, f, g,
    o) and the bias on the hidden side only (``bias_ih`` zero);
  * Faceformer's LayerNorm eps is flax's 1e-6, its GELU the tanh form;
  * the discriminator's k-4 stride-2 'SAME' convolution pads (1, 1) on an
    even length and (1, 2) on an odd one;
  * the text encoder's GPT-2 is this module's own (``GPT2Model``: GPT-2's
    layout, ``gelu_new`` (tanh GELU), LayerNorm eps 1e-5, a causal mask
    combined with the padding mask at the float32 minimum), frozen; the
    position ids ``cumsum(mask) - 1`` are -1 on left padding, which JAX's
    embedding lookup wraps to the last row, and so does this one.

Dropout draws from the ``generator`` passed to ``forward``, in training
mode only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from amuse_tpu_torch.models.transformer import MultiHeadAttention, dropout


def _conv1d(conv: nn.Conv1d, x: torch.Tensor, pads: tuple[int, int] = (0, 0),
            stride: int = 1) -> torch.Tensor:
    """(B, T, C) through ``conv`` after padding T by ``pads`` -> (B, T', C')."""
    h = F.pad(x.transpose(1, 2), pads)
    return F.conv1d(h, conv.weight, conv.bias, stride=stride,
                    dilation=conv.dilation).transpose(1, 2)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the last axis of (B, T, C)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.ndim - 1))
        if self.training:
            # two-pass biased variance: flax's E[x^2] - E[x]^2 cancels in
            # float32 once a channel's mean is large against its spread
            var, mean = torch.var_mean(x, dim=axes, correction=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


# ------------------------------------------------------------- text (GPT-2)


@dataclass(frozen=True)
class GPT2Config:
    """GPT-2's widths; the defaults are GPT-2 small's published ones."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


class GPT2Attention(nn.Module):
    """Causal self-attention with the packed ``c_attn`` projection."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.n_head = cfg.n_head
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.n_head
        q, k, v = (t.reshape(b, n, self.n_head, hd).transpose(1, 2)
                   for t in self.c_attn(x).split(d, dim=-1))
        scores = (q / math.sqrt(hd)) @ k.transpose(-1, -2) + bias
        return self.c_proj((torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, n, d))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))  # GPT-2's gelu_new


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.attn = GPT2Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.mlp = GPT2MLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """(B, L, D), additive (B, 1, L, L) attention bias -> (B, L, D)."""
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """GPT-2's transformer: (B, L) token ids -> (B, L, n_embd) last hidden state."""

    def __init__(self, cfg: GPT2Config = GPT2Config()):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList(GPT2Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        n = input_ids.shape[1]
        # JAX's lookup wraps a negative index (left padding's -1) to the last row
        pos = torch.remainder(position_ids, self.cfg.n_positions)
        x = self.wte(input_ids) + self.wpe(pos)
        causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        keep = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min).to(x.dtype)
        for block in self.h:
            x = block(x, bias)
        return self.ln_f(x)


class TextEncoder(nn.Module):
    """Frozen GPT-2 last hidden state -> (ReLU) -> projected text latents
    (reference TxtNet, txt_models.py:13-89). Takes token ids; tokenisation
    is the caller's. The default backbone is the JAX package's tiny one
    (64 wide, 2 layers, 2 heads)."""

    def __init__(self, latent_dim: int = 256, nonlinear: bool = True,
                 gpt2_config: Optional[GPT2Config] = None):
        super().__init__()
        self.nonlinear = nonlinear
        cfg = gpt2_config or GPT2Config(n_embd=64, n_layer=2, n_head=2)
        self.backbone = GPT2Model(cfg)
        self.backbone.requires_grad_(False)  # frozen, as the reference freezes GPT-2
        self.proj = nn.Linear(cfg.n_embd, latent_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) token ids, (B, L) 0/1 mask -> (B, L, latent_dim)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        position_ids = torch.cumsum(attention_mask, dim=-1) - 1
        with torch.no_grad():
            hidden = self.backbone(input_ids, attention_mask, position_ids)
        if self.nonlinear:
            hidden = F.relu(hidden)
        return self.proj(hidden)


# -------------------------------------------------------- TCN (txt_util.py)


class TemporalBlock(nn.Module):
    """Causal dilated conv block: two left-padded convs + ReLU + dropout, and
    a 1x1 residual conv when the channel count changes."""

    def __init__(self, in_channels: int, channels: int, kernel: int = 3, dilation: int = 1,
                 dropout: float = 0.25):
        super().__init__()
        self.pad, self.dropout = (kernel - 1) * dilation, dropout
        self.conv1 = nn.Conv1d(in_channels, channels, kernel, dilation=dilation)
        self.conv2 = nn.Conv1d(channels, channels, kernel, dilation=dilation)
        self.downsample = nn.Conv1d(in_channels, channels, 1) if in_channels != channels else None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        h = x
        for conv in (self.conv1, self.conv2):
            h = dropout(F.relu(_conv1d(conv, h, (self.pad, 0))), self.dropout, self.training,
                        generator)
        res = x if self.downsample is None else _conv1d(self.downsample, x)
        return F.relu(h + res)


class TemporalConvNet(nn.Module):
    """TemporalBlocks with doubling dilation (txt_util.py:78-93)."""

    def __init__(self, in_channels: int, num_channels: Sequence[int], kernel: int = 3,
                 dropout: float = 0.25):
        super().__init__()
        widths = [in_channels, *num_channels]
        self.blocks = nn.ModuleList(
            TemporalBlock(a, b, kernel, 2 ** i, dropout)
            for i, (a, b) in enumerate(zip(widths, widths[1:])))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for block in self.blocks:
            x = block(x, generator)
        return x


# ----------------------------------------------------- face (fac_util.py)


class ConvBasicBlock(nn.Module):
    """Residual conv1d block: conv-BN-LeakyReLU, conv-BN, an optional conv-BN
    shortcut, LeakyReLU of the sum (fac_util.py BasicBlock)."""

    def __init__(self, in_channels: int, channels: int, kernel: int = 3,
                 first_dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.pad1, self.pad2 = first_dilation, kernel // 2
        self.conv1 = nn.Conv1d(in_channels, channels, kernel)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv1d(channels, channels, kernel)
        self.bn2 = BatchNorm(channels)
        if downsample:
            self.down_conv = nn.Conv1d(in_channels, channels, kernel)
            self.down_bn = BatchNorm(channels)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = (self.pad1, self.pad1)
        h = F.leaky_relu(self.bn1(_conv1d(self.conv1, x, p1)), 0.01)
        h = self.bn2(_conv1d(self.conv2, h, (self.pad2, self.pad2)))
        identity = x if self.down_conv is None else self.down_bn(_conv1d(self.down_conv, x, p1))
        return F.leaky_relu(h + identity, 0.01)


class FaceNet(nn.Module):
    """Facial-coefficient encoder: 4 residual conv1d blocks, kernels 7-3-3-3,
    channels in -> latent/2 -> latent (fac_util.py FaceNet)."""

    def __init__(self, in_dim: int, latent_dim: int = 256):
        super().__init__()
        half = latent_dim // 2
        self.b0 = ConvBasicBlock(in_dim, half, 7, first_dilation=3, downsample=True)
        self.b1 = ConvBasicBlock(half, half, 3, first_dilation=1, downsample=True)
        self.b2 = ConvBasicBlock(half, half, 3, first_dilation=1)
        self.b3 = ConvBasicBlock(half, latent_dim, 3, first_dilation=1, downsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.b3(self.b2(self.b1(self.b0(x))))


# --------------------------------------------------- audio (wav_models.py)


class AudioNet(nn.Module):
    """Audio conditioning stream: disentangled features -> (ReLU) -> Linear;
    combined raw features through the causal TCN first (wav_models.py)."""

    def __init__(self, in_dim: int, latent_dim: int = 256, nonlinear: bool = True,
                 disentangled: bool = True, tcn_channels: Sequence[int] = (300,)):
        super().__init__()
        self.nonlinear = nonlinear
        self.tcn = None if disentangled else TemporalConvNet(in_dim, tcn_channels)
        self.proj = nn.Linear(in_dim if disentangled else tcn_channels[-1], latent_dim)

    def forward(self, feats: torch.Tensor, generator: Optional[torch.Generator] = None):
        if self.tcn is not None:
            feats = self.tcn(feats, generator)
        if self.nonlinear:
            feats = F.relu(feats)
        return self.proj(feats)


# --------------------------------------- fusion + addons (fusion_addon.py)


class FusionNet(nn.Module):
    """CaMN fusion MLP: Linear-LeakyReLU twice (fusion_addon.py:14-19)."""

    def __init__(self, in_dim: int, latent_dim: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, latent_dim)
        self.fc2 = nn.Linear(latent_dim, latent_dim)

    def forward(self, concat_feats: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(concat_feats), 0.01)
        return F.leaky_relu(self.fc2(h), 0.01)


class EmotionAddon(nn.Module):
    """Emotion id -> per-frame embedding and a conv-BN tail (fusion_addon.py:41-61)."""

    def __init__(self, latent_dim: int = 256, count: int = 8):
        super().__init__()
        self.embed = nn.Embedding(count, latent_dim)
        self.fc = nn.Linear(latent_dim, latent_dim)
        widths = (latent_dim, 8, 16, 16, latent_dim)
        self.convs = nn.ModuleList(nn.Conv1d(a, b, 9) for a, b in zip(widths, widths[1:]))
        self.bns = nn.ModuleList(BatchNorm(b) for b in widths[1:])

    def forward(self, emo_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) int -> (B, T, latent_dim)."""
        h = self.fc(self.embed(emo_ids))
        for conv, bn in zip(self.convs, self.bns):
            h = F.leaky_relu(bn(_conv1d(conv, h, (4, 4))), 0.3)
        return h


class SpeakerAddon(nn.Module):
    """Speaker id -> embedding -> Linear-LeakyReLU (fusion_addon.py:63-69)."""

    def __init__(self, latent_dim: int = 256, count: int = 30):
        super().__init__()
        self.embed = nn.Embedding(count, latent_dim)
        self.fc = nn.Linear(latent_dim, latent_dim)

    def forward(self, speaker_ids: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.fc(self.embed(speaker_ids)), 0.01)


# ------------------------------------------- CaMN generator ("lstm" arch)


@dataclass(frozen=True)
class CaMNConfig:
    nfeats: int = 168       # pose vector per frame (or n_face_feats)
    latent_dim: int = 256   # LSTM hidden
    fusion_dim: int = 256
    num_layers: int = 4
    dropout: float = 0.1
    # the conditioning streams the module holds (flax creates them at the
    # first call); a count or width of 0 leaves that stream out
    audio_dim: int = 256
    text_dim: int = 0
    num_emotions: int = 8
    num_speakers: int = 30


class CaMNPoseGenerator(nn.Module):
    """The CaMN fusion LSTM generator (PoseMDM arch "lstm",
    bvh_fac_models.py:97-155): the conditioning streams are fused,
    concatenated with the pose features per frame, run through a stacked
    LSTM and a Linear-LeakyReLU-Linear head back to pose space. A stream is
    used when its input is given."""

    def __init__(self, cfg: CaMNConfig = CaMNConfig()):
        super().__init__()
        self.cfg = cfg
        f = cfg.fusion_dim
        self.audio_net = AudioNet(cfg.audio_dim, f)
        self.txt_proj = nn.Linear(cfg.text_dim, f) if cfg.text_dim else None
        self.emo_addon = EmotionAddon(f, cfg.num_emotions) if cfg.num_emotions else None
        self.spk_addon = SpeakerAddon(f, cfg.num_speakers) if cfg.num_speakers else None
        n_streams = 1 + sum(m is not None for m in (self.txt_proj, self.emo_addon,
                                                     self.spk_addon))
        self.fusion = FusionNet(n_streams * f, f)
        self.lstm = nn.LSTM(f + cfg.nfeats, cfg.latent_dim, cfg.num_layers, batch_first=True)
        self.head1 = nn.Linear(cfg.latent_dim, cfg.latent_dim // 2)
        self.head2 = nn.Linear(cfg.latent_dim // 2, cfg.nfeats)

    def forward(self, pose: torch.Tensor, audio: torch.Tensor,
                emo_ids: Optional[torch.Tensor] = None,
                speaker_ids: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, nfeats) poses, (B, T, audio_dim), (B, T) int ids, (B, T,
        text_dim) -> (B, T, nfeats). BatchNorm follows the module's mode."""
        streams = [self.audio_net(audio)]
        for module, arg in ((self.txt_proj, text), (self.emo_addon, emo_ids),
                            (self.spk_addon, speaker_ids)):
            if arg is not None:
                if module is None:
                    raise ValueError("a conditioning stream was given that the config "
                                     "leaves out (CaMNConfig.text_dim / num_emotions / "
                                     "num_speakers)")
                streams.append(module(arg))
        fused = self.fusion(torch.cat(streams, dim=-1))
        h, _ = self.lstm(torch.cat([fused, pose], dim=-1))
        return self.head2(F.leaky_relu(self.head1(h), 0.01))


# --------------------------------- faceformer decoder ("trans_face_dec")


def periodic_positional_encoding(t: int, d: int, period: int = 25) -> torch.Tensor:
    """Faceformer PPE: the sinusoid repeats with ``period`` -> (t, d) float32."""
    pos = np.arange(t) % period
    i = np.arange(0, d, 2)
    angles = pos[:, None] / np.power(10000.0, i[None, :] / d)
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)[:, : pe[:, 1::2].shape[1]]
    return torch.from_numpy(pe)


def biased_causal_mask(t: int, period: int = 25) -> torch.Tensor:
    """ALiBi-style biased causal mask (single-head slope): an additive bias
    favouring recent periods, -inf above the diagonal -> (t, t) float32."""
    bias = -np.abs(np.arange(t)[:, None] // period - np.arange(t)[None, :] // period)
    mask = np.triu(np.full((t, t), -np.inf, np.float32), k=1)
    return torch.from_numpy((bias + mask).astype(np.float32))


class FaceformerLayer(nn.Module):
    def __init__(self, d: int, num_heads: int, ff_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln1 = nn.LayerNorm(d, eps=1e-6)
        self.self_qkv = nn.Linear(d, 3 * d)
        self.self_proj = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn = MultiHeadAttention(d, num_heads)
        self.ln3 = nn.LayerNorm(d, eps=1e-6)
        self.ff1 = nn.Linear(d, ff_size)
        self.ff2 = nn.Linear(ff_size, d)

    def forward(self, h: torch.Tensor, mem: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape
        hd = d // self.num_heads
        q, k, v = (x.reshape(b, t, self.num_heads, hd).transpose(1, 2)
                   for x in self.self_qkv(self.ln1(h)).split(d, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd) + bias, dim=-1)
        h = h + self.self_proj((attn @ v).transpose(1, 2).reshape(b, t, d))
        x = self.ln2(h)
        h = h + self.cross_attn(x, mem, mem)
        return h + self.ff2(F.gelu(self.ff1(self.ln3(h)), approximate="tanh"))


class FaceformerDecoder(nn.Module):
    """Teacher-forced facial decoder (PoseMDM modality "face", arch
    "trans_face_dec", bvh_fac_models.py:215-243): audio memory, speaker (and
    emotion) style vectors, periodic positions, biased causal self-attention
    over the right-shifted targets, and a zero-initialised output map, so a
    fresh decoder outputs 0."""

    def __init__(self, n_face_feats: int = 100, audio_dim: int = 256, latent_dim: int = 128,
                 num_heads: int = 4, ff_size: int = 512, num_layers: int = 2,
                 num_speakers: int = 30, num_emotions: int = 8, period: int = 25):
        super().__init__()
        self.latent_dim, self.period = latent_dim, period
        self.audio_feature_map = nn.Linear(audio_dim, latent_dim)
        self.obj_vector = nn.Embedding(num_speakers, latent_dim)
        # flax creates emo_vector at the first call with emotion ids; 0 leaves it out
        self.emo_vector = nn.Embedding(num_emotions, latent_dim) if num_emotions else None
        self.vertice_map = nn.Linear(n_face_feats, latent_dim)
        self.layers = nn.ModuleList(FaceformerLayer(latent_dim, num_heads, ff_size)
                                    for _ in range(num_layers))
        self.vertice_map_r = nn.Linear(latent_dim, n_face_feats)
        nn.init.zeros_(self.vertice_map_r.weight)
        nn.init.zeros_(self.vertice_map_r.bias)

    def forward(self, face: torch.Tensor, audio_memory: torch.Tensor,
                speaker_ids: torch.Tensor, emo_ids: Optional[torch.Tensor] = None):
        """(B, T, n_face_feats) targets, (B, T, audio_dim), (B,) int ids
        -> (B, T, n_face_feats)."""
        t = face.shape[1]
        mem = self.audio_feature_map(audio_memory)
        style = self.obj_vector(speaker_ids)
        if emo_ids is not None:
            if self.emo_vector is None:
                raise ValueError("emotion ids given to a FaceformerDecoder built with "
                                 "num_emotions=0")
            style = style + self.emo_vector(emo_ids)
        # teacher forcing sees frames < t only: a zero start token, then face[:, :-1]
        shifted = torch.cat([torch.zeros_like(face[:, :1]), face[:, :-1]], dim=1)
        h = self.vertice_map(shifted) + style[:, None, :]
        h = h + periodic_positional_encoding(t, self.latent_dim, self.period).to(h.device)
        bias = biased_causal_mask(t, self.period).to(h.device)
        for layer in self.layers:
            h = layer(h, mem, bias)
        return self.vertice_map_r(h)


# ------------------------------------------------------------ discriminator


class ConvDiscriminator(nn.Module):
    """Sequence discriminator: k-4 stride-2 'SAME' convs with LeakyReLU(0.2),
    the mean over time, one logit. (The reference's ConvDiscriminator is an
    empty module; this is the JAX package's working minimal version.)"""

    def __init__(self, in_feats: int = 168, channels: Sequence[int] = (64, 128)):
        super().__init__()
        widths = [in_feats, *channels]
        self.convs = nn.ModuleList(nn.Conv1d(a, b, 4) for a, b in zip(widths, widths[1:]))
        self.out = nn.Linear(widths[-1], 1)

    def forward(self, pose_seq: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B,) real/fake logit."""
        h = pose_seq
        for conv in self.convs:
            n = h.shape[1]
            total = max((-(-n // 2) - 1) * 2 + 4 - n, 0)
            h = F.leaky_relu(_conv1d(conv, h, (total // 2, total - total // 2), stride=2), 0.2)
        return self.out(h.mean(dim=1))[:, 0]
