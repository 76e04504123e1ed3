"""The residual add + LayerNorm of the AST's inference path on the CPU.

``ops.layer_norm.add_layer_norm`` takes its plain version on CPU tensors;
these tests hold that version to the arithmetic the trunk had before (the
bf16 or float32 add, then LayerNorm in float32 and one cast), the wrapper's
refusals, and ``ast_encode``'s inference path, which carries each block's
MLP residual into the next LayerNorm, to the block-by-block formula. The
CUDA kernel is held against the same plain version on the card
(tests/test_torch_port_gpu.py).
"""

import pytest
import torch
import torch.nn.functional as F

from amuse_tpu_torch.models import ast as tast
from amuse_tpu_torch.ops import layer_norm as tln
from amuse_tpu_torch.ops.attention import mha_reference

E = 16
TINY = dict(input_tdim=64, input_fdim=32, embed_dim=E, depth=2, num_heads=2, feature_dim=12)


def _randn(seed: int, *shape, scale: float = 1.0, shift: float = 0.0) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale + shift


def _plain_layer_norm(x, w, b, eps):
    """The trunk's LayerNorm as it was written: x (G, ..., E), w and b (G, E)."""
    shape = (w.shape[0],) + (1,) * (x.ndim - 2) + (w.shape[-1],)
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return (y * w.view(shape).float() + b.view(shape).float()).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("with_delta", [True, False])
def test_reference_is_the_plain_add_then_layer_norm(dtype, g, with_delta):
    x = _randn(0, g, 2, 5, E, scale=2.0, shift=0.5).to(dtype)
    delta = _randn(1, g, 2, 5, E).to(dtype) if with_delta else None
    w, b = _randn(2, g, E, scale=0.5, shift=1.0).to(dtype), _randn(3, g, E).to(dtype)
    s = x + delta if with_delta else x
    want = _plain_layer_norm(s, w, b, 1e-6)
    before = tln.add_layer_norm.launches
    for fn in (tln.add_layer_norm_reference, tln.add_layer_norm):
        got = fn(x, delta, w, b, 1e-6)
        if with_delta:
            assert torch.equal(got[0], s)
            got = got[1]
        assert got.dtype == dtype and torch.equal(got, want)
    assert tln.add_layer_norm.launches == before  # the CPU launches nothing


_X = torch.zeros(3, 5, E)
_W = torch.ones(3, E)


@pytest.mark.parametrize("args,match", [
    ((_X, torch.zeros(3, 4, E), _W, _W), "delta must have x's shape"),
    ((_X, None, torch.ones(2, E), torch.ones(2, E)), "weight and bias must be"),
    ((_X, None, _W, torch.ones(3, E + 8)), "weight and bias must be"),
    ((_X.half(), None, _W.half(), _W.half()), "float32 or bfloat16"),
    ((_X, None, _W.bfloat16(), _W), "float32 or bfloat16"),
    ((torch.zeros(3, 5, 12), None, torch.ones(3, 12), torch.ones(3, 12)), "width E = 12"),
    ((torch.zeros(3, 5, 1032), None, torch.ones(3, 1032), torch.ones(3, 1032)), "width E = 1032"),
    ((torch.zeros(E), None, _W, _W), r"\(G, \.\.\., E\)"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        tln.add_layer_norm(*args, 1e-6)


def test_wrapper_takes_the_widest_row():
    x = _randn(4, 1, 3, 1024)
    w, b = torch.ones(1, 1024), torch.zeros(1, 1024)
    assert torch.equal(tln.add_layer_norm(x, None, w, b, 1e-6), _plain_layer_norm(x, w, b, 1e-6))


def _plain_encode(p, spec, cfg, frame_based_feats):
    """``ast_encode`` as it was written before the residual was carried: each
    block adds its attention and MLP outputs to x itself."""
    pos = p["v.pos_embed"]
    g, e, n = pos.shape[0], cfg.embed_dim, spec.shape[0]
    patches = tast.extract_patches(spec.to(pos.dtype), cfg).reshape(1, -1, cfg.patch ** 2)
    w = p["v.patch_embed.proj.weight"].reshape(g, e, -1)
    x = torch.baddbmm(p["v.patch_embed.proj.bias"].unsqueeze(1), patches.expand(g, -1, -1),
                      w.transpose(1, 2)).view(g, n, cfg.num_patches, e)
    cls = p["v.cls_token"].view(g, 1, 1, e).expand(g, n, 1, e)
    dist = p["v.dist_token"].view(g, 1, 1, e).expand(g, n, 1, e)
    x = torch.cat([cls, dist, x], dim=2) + pos.view(g, 1, -1, e)

    def ln(t, name, eps=1e-6):
        return _plain_layer_norm(t, p[f"{name}.weight"], p[f"{name}.bias"], eps)

    s, hd = x.shape[2], e // cfg.num_heads
    for i in range(cfg.depth):
        pre = f"v.blocks.{i}"
        qkv = tast._linear(ln(x, f"{pre}.norm1"), p, f"{pre}.attn.qkv")
        qkv = qkv.view(g * n, s, 3, cfg.num_heads, hd)
        o = mha_reference(*(qkv[:, :, j].transpose(1, 2) for j in range(3)))
        x = x + tast._linear(o.transpose(1, 2).reshape(g, n, s, e), p, f"{pre}.attn.proj")
        h = F.gelu(tast._linear(ln(x, f"{pre}.norm2"), p, f"{pre}.mlp.fc1"))
        x = x + tast._linear(h, p, f"{pre}.mlp.fc2")
    x = ln(x, "v.norm")
    x_dist = 0.5 * (x[:, :, 0] + x[:, :, 1])
    pooled = x[:, :, 2:].mean(dim=2) if frame_based_feats else x_dist
    return tast._linear(ln(pooled, "feature_head.0", 1e-5), p, "feature_head.1"), x_dist


def _stacked_params(g: int, dtype) -> dict:
    cfg = tast.ASTConfig(**TINY)
    encoders = [tast.ASTEncoder(cfg) for _ in range(g)]
    gen = torch.Generator().manual_seed(g)
    with torch.no_grad():  # every parameter random, the LayerNorms' included
        for enc in encoders:
            for prm in enc.parameters():
                prm.copy_(0.3 * torch.randn(prm.shape, generator=gen) + (prm.ndim == 1))
    params = [dict(enc.named_parameters()) for enc in encoders]
    return {k: torch.stack([q[k].detach() for q in params]).to(dtype) for k in params[0]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frame_based_feats", [True, False])
def test_carried_residual_equals_block_by_block(dtype, frame_based_feats):
    cfg = tast.ASTConfig(**TINY)
    p = _stacked_params(3, dtype)
    spec = _randn(5, 2, cfg.input_tdim, cfg.input_fdim)
    want = _plain_encode(p, spec, cfg, frame_based_feats)
    with torch.no_grad():
        carried = tast.ast_encode(p, spec, cfg, frame_based_feats)
    p = {k: v.requires_grad_() for k, v in p.items()}
    grad = tast.ast_encode(p, spec, cfg, frame_based_feats)
    remat = tast.ast_encode(p, spec, tast.ASTConfig(**TINY, remat=True), frame_based_feats)
    for got in (carried, grad, remat):
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a.detach(), b.detach())


def test_vit_block_keeps_its_output_with_grad_off():
    """``ViTBlock.forward`` returns x + MLP(...) whether or not it is
    differentiated: with grad off the pending residual is added before it
    returns."""
    block = tast.ViTBlock(tast.ASTConfig(**TINY))
    x = _randn(6, 2, 9, E)
    want = block(x)
    with torch.no_grad():
        assert torch.equal(block(x), want.detach())
