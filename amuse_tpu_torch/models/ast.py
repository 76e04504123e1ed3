"""Audio Spectrogram Transformer encoders and the stage-1 speech disentangler.

Port of ``amuse_tpu/models/ast.py``: a ViT (deit-base-distilled-384: embed
768, 12 pre-norm blocks of 12 heads, LayerNorm eps 1e-6, exact-erf GELU MLP
3072) over overlapping 16x16 patches of a (1024, 128) fbank with stride 10,
cls + dist tokens, a LayerNorm + Linear feature head giving the 256-d
content / emotion / style feature, and label heads (emotion 8-way, speaker
30-way). The patch "conv" is patch extraction + one matmul: the same math as
the reference's stride-10 ``Conv2d``, without cuDNN.

The trunk is written once, in ``ast_encode``, over parameters stacked along
a leading encoder axis G, so the three encoders run as batched matmuls and
one attention call of batch G*N per block (kernel K1 forward; kernel K2 in
the backward when the call is differentiated). With grad off, each
LayerNorm and the residual add in front of it are one ``add_layer_norm``
(a hand-written kernel on CUDA), and ``ast_encode`` hands each block's MLP
residual to the next LayerNorm unadded. ``ASTEncoder`` (reference
keys ``v.*``, ``feature_head.*``, ``mlp_head*``) runs the same code with
G = 1. ``ASTDisentangler`` is the stage-1 model (reference ``AST_EVP``):
three encoders, the fusion blocks and the fbank decoder, computing in its
``dtype`` (bf16 on the main path) over float32 master parameters, with
LayerNorm statistics and softmax in float32, as the flax model's
``dtype=bf16, param_dtype=f32``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from amuse_tpu_torch.models.transformer import EncoderLayer
from amuse_tpu_torch.ops.attention import mha, mha_train
from amuse_tpu_torch.ops.layer_norm import add_layer_norm, layer_norm_reference

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
    # recompute each ViT block in the backward (torch.utils.checkpoint)
    # instead of keeping its activations; the block's K1 then runs twice
    remat: bool = False
    # tanh-approximate GELU in the ViT blocks' MLP: opt-in perf knob
    # (default exact erf, the torch/timm parity choice)
    gelu_tanh: bool = False

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
        self.num_heads, self.gelu_tanh = cfg.num_heads, cfg.gelu_tanh
        self.norm1 = nn.LayerNorm(d, eps=_VIT_LN_EPS)
        self.attn = _Attention(d)
        self.norm2 = nn.LayerNorm(d, eps=_VIT_LN_EPS)
        self.mlp = _Mlp(d, d * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, E) -> (B, S, E)."""
        return vit_block(x[None], _stacked(self), "", self.num_heads, self.gelu_tanh)[0]


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


def _head(in_dim: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(nn.LayerNorm(in_dim, eps=_HEAD_LN_EPS), nn.Linear(in_dim, out_dim))


class ASTEncoder(nn.Module):
    """One AST: fbank (B, 1024, 128) -> {"feature": (B, feature_dim), "logits"}.

    With ``label_dim`` it carries the reference's two label heads:
    ``mlp_head_featbased`` on the averaged cls/dist output (used with
    frame-based features) and ``mlp_head`` on the feature (used without);
    ``logits`` is None when ``label_dim`` is 0.
    """

    def __init__(self, cfg: ASTConfig = ASTConfig(), label_dim: int = 0):
        super().__init__()
        self.cfg, self.label_dim = cfg, label_dim
        self.v = _ViT(cfg)
        self.feature_head = _head(cfg.embed_dim, cfg.feature_dim)
        if label_dim:
            self.mlp_head = _head(cfg.feature_dim, label_dim)
            self.mlp_head_featbased = _head(cfg.embed_dim, label_dim)

    def forward(self, spec: torch.Tensor, frame_based_feats: bool = True) -> dict:
        feature, x_dist = ast_encode(_stacked(self), spec, self.cfg, frame_based_feats)
        logits = label_logits(self, feature[0], x_dist[0], frame_based_feats)
        return {"feature": feature[0].float(), "logits": logits}


def _stacked(module: nn.Module) -> dict[str, torch.Tensor]:
    return {name: p[None] for name, p in module.named_parameters()}


def _pre(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _add_norm(x: torch.Tensor, delta: Optional[torch.Tensor], p: dict, name: str,
              eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, LayerNorm(s)) over the last dim of x (G, ..., E) with the
    per-encoder LayerNorm ``name``, for s = x + delta (s = x when delta is
    None); statistics and affine in float32.

    With grad off, one ``add_layer_norm`` (a kernel on CUDA); with grad on,
    the plain add and ``layer_norm_reference``, which autograd differentiates.
    """
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if torch.is_grad_enabled():
        s = x if delta is None else x + delta
        return s, layer_norm_reference(s, w, b, eps)
    if delta is None:
        return x, add_layer_norm(x, None, w, b, eps)
    return add_layer_norm(x, delta, w, b, eps)


def _linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """Per-encoder Linear: x (G, ..., in) with weight (G, out, in) -> (G, ..., out)."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    g = w.shape[0]
    y = torch.baddbmm(b.unsqueeze(1), x.reshape(g, -1, x.shape[-1]), w.transpose(1, 2))
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def _block(x: torch.Tensor, delta: Optional[torch.Tensor], p: dict, prefix: str,
           num_heads: int, gelu_tanh: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm ViT block on x + delta, delta the previous block's pending
    MLP residual (or None) -> (x', mlp): the block's output is x' + mlp, left
    for the next LayerNorm to add."""
    x, h = _add_norm(x, delta, p, _pre(prefix, "norm1"), _VIT_LN_EPS)
    g, n, s, e = x.shape
    qkv = _linear(h, p, _pre(prefix, "attn.qkv")).view(g * n, s, 3, num_heads, e // num_heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        o = mha_train(qkv)
    else:  # strided (G*N, H, S, hd) views of the fused projection: no copies
        o = mha(*(qkv[:, :, i].transpose(1, 2) for i in range(3)))
    attn = _linear(o.transpose(1, 2).reshape(g, n, s, e), p, _pre(prefix, "attn.proj"))
    x, h = _add_norm(x, attn, p, _pre(prefix, "norm2"), _VIT_LN_EPS)
    h = F.gelu(_linear(h, p, _pre(prefix, "mlp.fc1")),
               approximate="tanh" if gelu_tanh else "none")
    return x, _linear(h, p, _pre(prefix, "mlp.fc2"))


def vit_block(x: torch.Tensor, p: dict, prefix: str, num_heads: int,
              gelu_tanh: bool = False) -> torch.Tensor:
    """One pre-norm ViT block on x (G, N, S, E) with stacked params ``p``.

    Attention is ``mha_train`` (K1 forward, K2 backward on CUDA) when the
    call is differentiated, else the forward-only ``mha``; with grad off each
    LayerNorm and the residual add before it are one ``add_layer_norm``.
    """
    x, mlp = _block(x, None, p, prefix, num_heads, gelu_tanh)
    return x + mlp


def ast_encode(p: dict, spec: torch.Tensor, cfg: ASTConfig,
               frame_based_feats: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked encoders: fbank (N, T, F) -> (feature (G, N, feature_dim),
    x_dist (G, N, E)), both in ``p``'s dtype, which the compute runs in.

    ``p`` holds ``ASTEncoder`` trunk parameter names with a leading axis G.
    ``frame_based_feats`` pools the patch tokens by their mean (True) or
    takes ``x_dist``, the mean of the cls/dist outputs (False).
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
    delta = None  # the last block's MLP output, added by the next LayerNorm
    for i in range(cfg.depth):
        args = (p, f"v.blocks.{i}", cfg.num_heads, cfg.gelu_tanh)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(vit_block, x, *args, use_reentrant=False)
        else:
            x, delta = _block(x, delta, *args)
    _, x = _add_norm(x, delta, p, "v.norm", _VIT_LN_EPS)
    x_dist = 0.5 * (x[:, :, 0] + x[:, :, 1])
    pooled = x[:, :, 2:].mean(dim=2) if frame_based_feats else x_dist
    _, h = _add_norm(pooled, None, p, "feature_head.0", _HEAD_LN_EPS)
    return _linear(h, p, "feature_head.1"), x_dist


def ast_features(p: dict, spec: torch.Tensor, cfg: ASTConfig,
                 frame_based_feats: bool = True) -> torch.Tensor:
    """Stacked encoders' features: fbank (N, T, F) -> (G, N, feature_dim) float32."""
    return ast_encode(p, spec, cfg, frame_based_feats)[0].float()


def label_logits(enc: ASTEncoder, feature: torch.Tensor, x_dist: torch.Tensor,
                 frame_based_feats: bool) -> Optional[torch.Tensor]:
    """The encoder's label head on one encoder's (N, ...) trunk outputs, in
    their dtype -> (N, label_dim) float32, or None without a label head."""
    if not enc.label_dim:
        return None
    head = enc.mlp_head_featbased if frame_based_feats else enc.mlp_head
    x = x_dist if frame_based_feats else feature
    ln, fc = head
    h = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), ln.eps)
    return F.linear(h.to(x.dtype), fc.weight.to(x.dtype), fc.bias.to(x.dtype)).float()


class _LayerStack(nn.Module):
    """Post-norm transformer layers (4 heads, ff 2048, ReLU) over the
    batch-as-sequence, then a LayerNorm.

    Reference quirk kept (``AST_EVP.py:12-42``): a (B, in) input runs as ONE
    length-B sequence, so self-attention mixes the batch; a (G, B, in) input
    is G independent length-B sequences (the training step batches its 16
    swap groups so).
    """

    def __init__(self, in_dim: int, num_layers: int, dropout: float):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(in_dim, 4, 2048, "relu", False, dropout)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(in_dim, eps=1e-5)

    def trunk(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        h = x[None] if x.ndim == 2 else x
        for layer in self.layers:
            h = layer(h, None, generator)
        h = self.norm(h)
        return h[0] if x.ndim == 2 else h


class FusionBlock(_LayerStack):
    """Two layers + LayerNorm + Linear(in, out) (``AST_EVP.py:12-24``)."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 2, dropout: float = 0.1):
        super().__init__(in_dim, num_layers, dropout)
        self.fc = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc(self.trunk(x, generator))


class DecoderBlock(_LayerStack):
    """Four layers + LayerNorm + Linear(in, 2 in) ReLU Linear(2 in,
    frames * bins), reshaped to an fbank (``AST_EVP.py:26-42``)."""

    def __init__(self, in_dim: int = 512, out_frames: int = 1024, out_bins: int = 128,
                 num_layers: int = 4, dropout: float = 0.1):
        super().__init__(in_dim, num_layers, dropout)
        self.out_shape = (out_frames, out_bins)
        self.projection = nn.Sequential(nn.Linear(in_dim, 2 * in_dim), nn.ReLU(),
                                        nn.Linear(2 * in_dim, out_frames * out_bins))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.projection(self.trunk(x, generator))
        return h.reshape(h.shape[:-1] + self.out_shape)


ENCODERS = ("emo", "sty", "con")  # stacking order of the disentangler's encoders
LABEL_DIMS = {"emo": 8, "sty": 30, "con": 0}


class ASTDisentangler(nn.Module):
    """The stage-1 triple-encoder disentangler (reference ``AST_EVP``).

    Parameters keep the reference keys (``emo_enc.*``, ``fusion.*``,
    ``fusion_ablation.*``, ``decode.*``) in float32; ``dtype`` is the compute
    type. Methods: ``encode`` (fbank -> per-encoder feature and logits),
    ``reconstruct`` ([emo|sty|con] features -> fbank) and
    ``reconstruct_ablation`` ([emo-or-sty|con] -> fbank). Dropout (0.1, the
    fusion and decoder layers only) is active in training mode and draws
    from the ``generator`` passed in.
    """

    def __init__(self, cfg: ASTConfig = ASTConfig(), fusion_dim: int = 512,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        for name in ENCODERS:
            setattr(self, f"{name}_enc", ASTEncoder(cfg, LABEL_DIMS[name]))
        fd = cfg.feature_dim
        self.fusion = FusionBlock(3 * fd, fusion_dim, 2, dropout)
        self.fusion_ablation = FusionBlock(2 * fd, fusion_dim, 2, dropout)
        self.decode = DecoderBlock(fusion_dim, cfg.input_tdim, cfg.input_fdim, 4, dropout)

    def encoders(self) -> list[ASTEncoder]:
        return [getattr(self, f"{name}_enc") for name in ENCODERS]

    def stacked_trunks(self) -> dict[str, torch.Tensor]:
        """The three encoders' trunk parameters stacked (3, ...) and cast to
        ``dtype``: differentiable, so gradients reach each encoder's float32
        parameters. Costs one stack and one cast of the trunks per call."""
        encs = self.encoders()
        names = [n for n, _ in encs[-1].named_parameters()]  # con_enc: no label head
        params = [dict(e.named_parameters()) for e in encs]
        return {n: torch.stack([p[n] for p in params]).to(self.dtype) for n in names}

    def encode(self, spec: torch.Tensor, frame_based_feats: bool = True) -> dict:
        """fbank (N, T, F) -> {emo, sty, con: {"feature" (N, fd), "logits"}}, float32."""
        feature, x_dist = ast_encode(self.stacked_trunks(), spec, self.cfg, frame_based_feats)
        return {name: {"feature": feature[i].float(),
                       "logits": label_logits(enc, feature[i], x_dist[i], frame_based_feats)}
                for i, (name, enc) in enumerate(zip(ENCODERS, self.encoders()))}

    def _run(self, block: nn.Module, x: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """``block`` computing in ``dtype`` over its float32 parameters."""
        params = {n: p.to(self.dtype) for n, p in block.named_parameters()}
        return torch.func.functional_call(block, params, (x.to(self.dtype), generator))

    def reconstruct(self, feats: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """([G,] B, 3 fd) [emo|sty|con] features -> ([G,] B, T, F) fbank."""
        return self._run(self.decode, self._run(self.fusion, feats, generator), generator)

    def reconstruct_ablation(self, feats: torch.Tensor,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """([G,] B, 2 fd) [emo-or-sty|con] features -> ([G,] B, T, F) fbank."""
        latent = self._run(self.fusion_ablation, feats, generator)
        return self._run(self.decode, latent, generator)
