"""Audio Spectrogram Transformer encoders, feature path.

Port of the feature path of ``amuse_tpu/models/ast.py``: a ViT
(deit-base-distilled-384: embed 768, 12 pre-norm blocks of 12 heads,
LayerNorm eps 1e-6, exact-erf GELU MLP 3072) over overlapping 16x16 patches
of a (1024, 128) fbank with stride 10, cls + dist tokens, and a
LayerNorm + Linear feature head giving the 256-d content / emotion / style
feature. The patch "conv" is patch extraction + one matmul: the same math as
the reference's stride-10 ``Conv2d``, without cuDNN.

The forward is written once, in ``ast_features``, over parameters stacked
along a leading encoder axis G, so the inference pipeline runs its three
encoders (G = 3) as batched matmuls and one attention call of batch G*N per
block. ``ASTEncoder`` (reference keys ``v.*``, ``feature_head.*``) runs the
same code with G = 1. Attention goes through ``ops.attention.mha``: kernel
K1 on CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amuse_tpu_torch.ops.attention import mha

_VIT_LN_EPS = 1e-6
_HEAD_LN_EPS = 1e-5


@dataclass(frozen=True)
class ASTConfig:
    input_tdim: int = 1024
    input_fdim: int = 128
    patch: int = 16
    fstride: int = 10
    tstride: int = 10
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    feature_dim: int = 256

    @property
    def f_patches(self) -> int:
        return (self.input_fdim - self.patch) // self.fstride + 1  # 12

    @property
    def t_patches(self) -> int:
        return (self.input_tdim - self.patch) // self.tstride + 1  # 101

    @property
    def num_patches(self) -> int:
        return self.f_patches * self.t_patches  # 1212


def extract_patches(spec: torch.Tensor, cfg: ASTConfig) -> torch.Tensor:
    """(B, T, F) fbank -> (B, num_patches, patch*patch) overlapping patches.

    Equals Conv2d(1, E, patch, stride=(fstride, tstride)) on (B, 1, F, T):
    patch rows run over frequency, columns over time, pixels flattened
    row-major over (freq, time) like the conv weight.
    """
    x = spec.transpose(-1, -2)  # (B, F, T)
    x = x.unfold(1, cfg.patch, cfg.fstride).unfold(2, cfg.patch, cfg.tstride)
    return x.reshape(x.shape[0], cfg.num_patches, cfg.patch * cfg.patch)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.embed_dim, cfg.patch, stride=(cfg.fstride, cfg.tstride))


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-norm ViT block (timm): LN -> MHA -> +res; LN -> MLP -> +res."""

    def __init__(self, cfg: ASTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(d, eps=_VIT_LN_EPS)
        self.attn = _Attention(d)
        self.norm2 = nn.LayerNorm(d, eps=_VIT_LN_EPS)
        self.mlp = _Mlp(d, d * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, E) -> (B, S, E)."""
        return vit_block(x[None], _stacked(self), "", self.num_heads)[0]


class _ViT(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        e = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, cfg.num_patches + 2, e), std=0.02)
        )
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(e, eps=_VIT_LN_EPS)


class ASTEncoder(nn.Module):
    """One AST: fbank (B, 1024, 128) -> (B, feature_dim) float32 feature."""

    def __init__(self, cfg: ASTConfig = ASTConfig()):
        super().__init__()
        self.cfg = cfg
        self.v = _ViT(cfg)
        self.feature_head = nn.Sequential(
            nn.LayerNorm(cfg.embed_dim, eps=_HEAD_LN_EPS), nn.Linear(cfg.embed_dim, cfg.feature_dim)
        )

    def forward(self, spec: torch.Tensor, frame_based_feats: bool = True) -> torch.Tensor:
        return ast_features(_stacked(self), spec, self.cfg, frame_based_feats)[0]


def _stacked(module: nn.Module) -> dict[str, torch.Tensor]:
    return {name: p[None] for name, p in module.named_parameters()}


def _pre(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _layer_norm(x: torch.Tensor, p: dict, name: str, eps: float) -> torch.Tensor:
    """Per-encoder LayerNorm over the last dim of x (G, ..., E), in float32."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    shape = (w.shape[0],) + (1,) * (x.ndim - 2) + (w.shape[-1],)
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * w.view(shape).float() + b.view(shape).float()).to(x.dtype)


def _linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """Per-encoder Linear: x (G, ..., in) with weight (G, out, in) -> (G, ..., out)."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    g = w.shape[0]
    y = torch.baddbmm(b.unsqueeze(1), x.reshape(g, -1, x.shape[-1]), w.transpose(1, 2))
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def vit_block(x: torch.Tensor, p: dict, prefix: str, num_heads: int) -> torch.Tensor:
    """One pre-norm ViT block on x (G, N, S, E) with stacked params ``p``."""
    g, n, s, e = x.shape
    hd = e // num_heads
    h = _layer_norm(x, p, _pre(prefix, "norm1"), _VIT_LN_EPS)
    qkv = _linear(h, p, _pre(prefix, "attn.qkv")).view(g * n, s, 3, num_heads, hd)
    # strided (G*N, H, S, hd) views of the fused projection: no copies
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = mha(q, k, v).transpose(1, 2).reshape(g, n, s, e)
    x = x + _linear(o, p, _pre(prefix, "attn.proj"))
    h = _layer_norm(x, p, _pre(prefix, "norm2"), _VIT_LN_EPS)
    h = F.gelu(_linear(h, p, _pre(prefix, "mlp.fc1")), approximate="none")
    return x + _linear(h, p, _pre(prefix, "mlp.fc2"))


def ast_features(p: dict, spec: torch.Tensor, cfg: ASTConfig,
                 frame_based_feats: bool = True) -> torch.Tensor:
    """Stacked encoders' features: fbank (N, T, F) -> (G, N, feature_dim) float32.

    ``p`` holds ``ASTEncoder`` parameter names with a leading axis G; the
    compute runs in ``p``'s dtype. ``frame_based_feats`` pools the patch
    tokens by their mean (True) or averages the cls/dist outputs (False).
    """
    pos = p["v.pos_embed"]
    g, dtype, e = pos.shape[0], pos.dtype, cfg.embed_dim
    n = spec.shape[0]
    patches = extract_patches(spec.to(dtype), cfg).reshape(1, -1, cfg.patch * cfg.patch)
    w = p["v.patch_embed.proj.weight"].reshape(g, e, -1)
    x = torch.baddbmm(p["v.patch_embed.proj.bias"].unsqueeze(1),
                      patches.expand(g, -1, -1), w.transpose(1, 2))
    x = x.view(g, n, cfg.num_patches, e)
    cls = p["v.cls_token"].view(g, 1, 1, e).expand(g, n, 1, e)
    dist = p["v.dist_token"].view(g, 1, 1, e).expand(g, n, 1, e)
    x = torch.cat([cls, dist, x], dim=2) + pos.view(g, 1, -1, e)
    for i in range(cfg.depth):
        x = vit_block(x, p, f"v.blocks.{i}", cfg.num_heads)
    x = _layer_norm(x, p, "v.norm", _VIT_LN_EPS)
    pooled = x[:, :, 2:].mean(dim=2) if frame_based_feats else 0.5 * (x[:, :, 0] + x[:, :, 1])
    h = _layer_norm(pooled, p, "feature_head.0", _HEAD_LN_EPS)
    return _linear(h, p, "feature_head.1").float()
