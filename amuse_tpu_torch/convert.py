"""JAX package parameters -> the port's state dicts (reference AMUSE key names).

``from_jax_params`` takes the JAX pipeline's parameters as a nested dict of
numpy arrays (``{"ast": ..., "prior": ..., "denoiser": ...}`` or a
NamedTuple with those fields) and returns a ``PipelineParams`` of float32
torch tensors that ``GesturePipeline`` and the port's modules load. It is
the inverse, for the three models, of the JAX package's
``utils/torch_import.py``: flax ``Dense`` kernels (in, out) become torch
weights (out, in), separate q/k/v projections become the packed
``in_proj_weight``, the AST patch matmul kernel (256, E) becomes the
(E, 1, 16, 16) conv weight, and positional tables gain the reference's
(max_len, 1, d) layout. Both AST layouts of the JAX pipeline are accepted:
``{emo_enc, sty_enc, con_enc}`` (the stage-1 model) and ``{con, emo, sty}``.
``disentangler_from_jax`` maps the whole stage-1 ``ASTDisentangler`` tree
(encoders with their label head, fusion, fusion_ablation, decoder). The maps
are linear, so they carry gradient trees too.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from amuse_tpu_torch.infer.pipeline import ENCODERS, PipelineParams


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(p: Mapping, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _mha(p: Mapping, out: dict, prefix: str) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    out[f"{prefix}.in_proj_weight"] = _t(np.concatenate([np.asarray(p[n]["kernel"]).T for n in names]))
    out[f"{prefix}.in_proj_bias"] = _t(np.concatenate([np.asarray(p[n]["bias"]) for n in names]))
    _linear(p["out_proj"], out, f"{prefix}.out_proj")


def _layer(p: Mapping, out: dict, prefix: str) -> None:
    """Encoder layer, or decoder layer when ``cross_attn`` is present."""
    _mha(p["self_attn"], out, f"{prefix}.self_attn")
    _linear(p["ffn"]["linear1"], out, f"{prefix}.linear1")
    _linear(p["ffn"]["linear2"], out, f"{prefix}.linear2")
    _layernorm(p["norm1"], out, f"{prefix}.norm1")
    _layernorm(p["norm2"], out, f"{prefix}.norm2")
    if "cross_attn" in p:
        _mha(p["cross_attn"], out, f"{prefix}.multihead_attn")
        _layernorm(p["norm3"], out, f"{prefix}.norm3")


def _skip_stack(p: Mapping, out: dict, prefix: str) -> None:
    n = sum(1 for k in p if k.startswith("in_"))
    for i in range(n):
        _layer(p[f"in_{i}"], out, f"{prefix}.input_blocks.{i}")
        _layer(p[f"out_{i}"], out, f"{prefix}.output_blocks.{i}")
        _linear(p[f"skip_{i}"], out, f"{prefix}.linear_blocks.{i}")
    _layer(p["mid"], out, f"{prefix}.middle_block")
    _layernorm(p["norm"], out, f"{prefix}.norm")


def _pos(pe) -> torch.Tensor:
    return _t(np.asarray(pe)[:, None, :])  # (max_len, d) -> (max_len, 1, d)


def prior_from_jax(p: Mapping) -> dict:
    """flax MotionPrior params -> MotionPrior state dict."""
    enc, dec = p["encoder"], p["decoder"]
    out = {"global_motion_token": _t(enc["dist_tokens"]),
           "query_pos_encoder.pe": _pos(enc["pos"]["pe"]),
           "query_pos_decoder.pe": _pos(dec["pos"]["pe"])}
    _linear(enc["skel_embedding"], out, "skel_embedding")
    _skip_stack(enc["encoder"], out, "encoder")
    _skip_stack(dec["decoder"], out, "decoder")
    _linear(dec["final_layer"], out, "final_layer")
    return out


def denoiser_from_jax(p: Mapping) -> dict:
    """flax Denoiser params -> Denoiser state dict."""
    out = {"query_pos.pe": _pos(p["pos"]["pe"])}
    _linear(p["time_mlp"]["linear_1"], out, "time_embedding.linear_1")
    _linear(p["time_mlp"]["linear_2"], out, "time_embedding.linear_2")
    for name in ENCODERS:
        _linear(p[f"proj_{name}"]["linear"], out, f"emb_proj_{name}.1")
    _skip_stack(p["encoder"], out, "encoder")
    return out


def ast_encoder_from_jax(p: Mapping, prefix: str = "") -> dict:
    """flax ASTEncoder params -> ASTEncoder state dict, with whichever label
    head the flax tree holds (``featbased_*`` -> ``mlp_head_featbased``,
    ``mlp_*`` -> ``mlp_head``)."""
    pre = f"{prefix}." if prefix else ""
    out = {}
    for flax_name, head in (("featbased", "mlp_head_featbased"), ("mlp", "mlp_head")):
        if f"{flax_name}_ln" in p:
            _layernorm(p[f"{flax_name}_ln"], out, f"{pre}{head}.0")
            _linear(p[f"{flax_name}_fc"], out, f"{pre}{head}.1")
    kernel = np.asarray(p["patch_proj"]["kernel"])  # (patch*patch, E)
    patch = math.isqrt(kernel.shape[0])
    out.update({
        f"{pre}v.patch_embed.proj.weight": _t(kernel.T.reshape(kernel.shape[1], 1, patch, patch)),
        f"{pre}v.patch_embed.proj.bias": _t(p["patch_proj"]["bias"]),
        f"{pre}v.cls_token": _t(p["cls_token"]),
        f"{pre}v.dist_token": _t(p["dist_token"]),
        f"{pre}v.pos_embed": _t(p["pos_embed"]),
    })
    _layernorm(p["norm"], out, f"{pre}v.norm")
    _layernorm(p["feature_ln"], out, f"{pre}feature_head.0")
    _linear(p["feature_fc"], out, f"{pre}feature_head.1")
    depth = sum(1 for k in p if k.startswith("block_"))
    for i in range(depth):
        b, bp = p[f"block_{i}"], f"{pre}v.blocks.{i}"
        _layernorm(b["norm1"], out, f"{bp}.norm1")
        _linear(b["qkv"], out, f"{bp}.attn.qkv")
        _linear(b["attn_proj"], out, f"{bp}.attn.proj")
        _layernorm(b["norm2"], out, f"{bp}.norm2")
        _linear(b["mlp_fc1"], out, f"{bp}.mlp.fc1")
        _linear(b["mlp_fc2"], out, f"{bp}.mlp.fc2")
    return out


def _layer_stack(p: Mapping, out: dict, prefix: str) -> None:
    """flax FusionBlock / DecoderBlock layers + norm -> ``<prefix>.layers.{i}``, ``.norm``."""
    for i in range(sum(1 for k in p if k.startswith("layer_"))):
        _layer(p[f"layer_{i}"], out, f"{prefix}.layers.{i}")
    _layernorm(p["norm"], out, f"{prefix}.norm")


def disentangler_from_jax(tree: Mapping) -> dict:
    """flax ``ASTDisentangler`` params -> the port's ``ASTDisentangler`` state
    dict (reference ``AST_EVP`` keys).

    flax holds only the label head of the ``frame_based_feats`` branch traced
    at init; that head is mapped and the other one is absent from the result
    (load with ``strict=False``).
    """
    out = {}
    for name in ("emo", "sty", "con"):
        out.update(ast_encoder_from_jax(tree[f"{name}_enc"], f"{name}_enc"))
    for block in ("fusion", "fusion_ablation"):
        _layer_stack(tree[block], out, block)
        _linear(tree[block]["fc"], out, f"{block}.fc")
    _layer_stack(tree["decoder"], out, "decode")
    _linear(tree["decoder"]["proj1"], out, "decode.projection.0")
    _linear(tree["decoder"]["proj2"], out, "decode.projection.2")
    return out


def from_jax_params(tree) -> PipelineParams:
    """JAX ``PipelineParams`` (or a dict with its fields) -> the port's ``PipelineParams``."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    ast_tree = tree["ast"]
    ast = {}
    for name in ENCODERS:
        enc = ast_tree[f"{name}_enc"] if f"{name}_enc" in ast_tree else ast_tree[name]
        ast.update(ast_encoder_from_jax(enc, f"{name}_enc"))
    return PipelineParams(ast=ast, prior=prior_from_jax(tree["prior"]),
                          denoiser=denoiser_from_jax(tree["denoiser"]))
