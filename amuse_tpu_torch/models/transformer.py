"""Transformer building blocks of the motion prior VAE and the denoiser.

Port of ``amuse_tpu/models/transformer.py``: post-norm (or pre-norm)
encoder/decoder layers with ``nn.MultiheadAttention`` semantics (packed
q/k/v ``in_proj`` + ``out_proj``, LayerNorm eps 1e-5, exact-erf GELU), the
U-Net "skip transformer" stacks, and additive learned positional
embeddings. Batch-first ``(B, T, D)``. Parameter names are the reference
AMUSE state-dict keys (DETR-style ``cross_attention.py``), so a reference
state dict loads with ``load_state_dict``. Attention here is plain torch
ops: its JAX counterpart is XLA einsum, not a Pallas kernel.

``EncoderLayer(dropout=p)`` drops, in training mode only, the attention
weights, the FFN activation and both residual branches, as the JAX layer
does; ``DecoderLayer(dropout=p)`` the same around its self- and
cross-attention and FFN. The masks come from the ``torch.Generator`` passed
to ``forward`` (the skip stacks pass theirs to every layer). With the
default ``dropout=0.0`` (inference) nothing is drawn.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_TORCH_LN_EPS = 1e-5


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep with probability 1 - p,
    scale kept values by 1 / (1 - p); the identity unless training and p > 0."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _activation(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")  # exact erf form
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation: {name}")


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention``-keyed attention, batch-first.

    ``key_padding_mask`` is a (B, Tk) boolean keep-mask (True = attend), the
    JAX package's convention. ``dropout`` applies to the attention weights
    in training mode.
    """

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        d, h = self.d_model, self.num_heads
        hd = d // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(x):  # (B, T, D) -> (B, H, T, hd)
            return x.reshape(x.shape[:-1] + (h, hd)).transpose(-3, -2)

        q = split(F.linear(query, wq, bq))
        k = split(F.linear(key, wk, bk))
        v = split(F.linear(value, wv, bv))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if key_padding_mask is not None:
            neg = torch.finfo(torch.float32).min
            scores = scores.masked_fill(~key_padding_mask[:, None, None, :], neg)
        attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        attn = dropout(attn, self.dropout, self.training, generator)
        out = (attn @ v).transpose(-3, -2).reshape(query.shape[:-1] + (d,))
        return self.out_proj(out)


def feed_forward(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear,
                 activation: str = "gelu", drop=lambda y: y) -> torch.Tensor:
    """Linear -> activation -> ``drop`` -> Linear: the layers' FFN."""
    return linear2(drop(_activation(activation)(linear1(x))))


class EncoderLayer(nn.Module):
    """Post-norm (default) or pre-norm transformer encoder layer."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 activation: str = "gelu", normalize_before: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.activation = activation
        self.normalize_before = normalize_before

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        def drop(y):
            return dropout(y, self.dropout, self.training, generator)

        def attn(y):
            return drop(self.self_attn(y, y, y, key_padding_mask, generator))

        def ffn(y):
            return drop(feed_forward(y, self.linear1, self.linear2, self.activation, drop))

        if self.normalize_before:
            x = x + attn(self.norm1(x))
            return x + ffn(self.norm2(x))
        x = self.norm1(x + attn(x))
        return self.norm2(x + ffn(x))


class DecoderLayer(nn.Module):
    """Post/pre-norm decoder layer: self-attn -> cross-attn -> FFN."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 activation: str = "gelu", normalize_before: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)
        self.activation = activation
        self.normalize_before = normalize_before

    def forward(
        self,
        tgt: torch.Tensor,
        memory: torch.Tensor,
        tgt_key_padding_mask: Optional[torch.Tensor] = None,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        def drop(y):
            return dropout(y, self.dropout, self.training, generator)

        def self_attn(y):
            return drop(self.self_attn(y, y, y, tgt_key_padding_mask, generator))

        def cross_attn(y):
            return drop(self.multihead_attn(y, memory, memory, memory_key_padding_mask,
                                            generator))

        def ffn(y):
            return drop(feed_forward(y, self.linear1, self.linear2, self.activation, drop))

        if self.normalize_before:
            tgt = tgt + self_attn(self.norm1(tgt))
            tgt = tgt + cross_attn(self.norm2(tgt))
            return tgt + ffn(self.norm3(tgt))
        tgt = self.norm1(tgt + self_attn(tgt))
        tgt = self.norm2(tgt + cross_attn(tgt))
        return self.norm3(tgt + ffn(tgt))


class _SkipStack(nn.Module):
    """U-Net skip stack (reference ``SkipTransformerEncoder/Decoder``).

    num_layers must be odd: (L-1)/2 input blocks, a middle block, (L-1)/2
    output blocks each fed by ``Linear(cat(x, skip))``, then a LayerNorm.
    ``dropout`` is every layer's.
    """

    def __init__(self, layer_cls, d_model: int, num_heads: int, ff_size: int,
                 num_layers: int, activation: str, normalize_before: bool, dropout: float):
        super().__init__()
        if num_layers % 2 != 1:
            raise ValueError(f"skip stack needs an odd layer count, got {num_layers}")
        n = (num_layers - 1) // 2

        def make():
            return layer_cls(d_model, num_heads, ff_size, activation, normalize_before, dropout)

        self.input_blocks = nn.ModuleList(make() for _ in range(n))
        self.middle_block = make()
        self.output_blocks = nn.ModuleList(make() for _ in range(n))
        self.linear_blocks = nn.ModuleList(nn.Linear(2 * d_model, d_model) for _ in range(n))
        self.norm = nn.LayerNorm(d_model, eps=_TORCH_LN_EPS)

    def _run(self, x, call):
        skips = []
        for block in self.input_blocks:
            x = call(block, x)
            skips.append(x)
        x = call(self.middle_block, x)
        for block, linear in zip(self.output_blocks, self.linear_blocks):
            x = call(block, linear(torch.cat([x, skips.pop()], dim=-1)))
        return self.norm(x)


class SkipEncoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int = 9,
                 activation: str = "gelu", normalize_before: bool = False,
                 dropout: float = 0.0):
        super().__init__(EncoderLayer, d_model, num_heads, ff_size, num_layers,
                         activation, normalize_before, dropout)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self._run(x, lambda block, h: block(h, key_padding_mask, generator))


class SkipDecoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int = 9,
                 activation: str = "gelu", normalize_before: bool = False,
                 dropout: float = 0.0):
        super().__init__(DecoderLayer, d_model, num_heads, ff_size, num_layers,
                         activation, normalize_before, dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self._run(tgt, lambda block, h: block(h, memory, tgt_key_padding_mask, None,
                                                     generator))


class LearnedPositionalEmbedding(nn.Module):
    """Additive learned 1-D positional embedding, uniform[0, 1) initialised.

    The parameter keeps the reference layout ``pe`` (max_len, 1, d_model);
    the leading T positions are added to a (B, T, D) input.
    """

    def __init__(self, d_model: int, max_len: int = 500):
        super().__init__()
        self.pe = nn.Parameter(torch.rand(max_len, 1, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[: x.shape[-2], 0].to(x.dtype)


def lengths_to_mask(lengths: Optional[torch.Tensor], max_len: int) -> Optional[torch.Tensor]:
    """(B,) lengths -> (B, T) boolean keep-mask; None -> None (full attention)."""
    if lengths is None:
        return None
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
