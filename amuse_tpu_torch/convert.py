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

``legacy_from_jax`` maps the legacy zoo (``models/raw_diffusion.py``,
``audio_legacy.py``, ``legacy_family.py``, ``actor.py``) by registry tag
or class name: convolution kernels (*spatial, in, out) become (out, in,
*spatial), BatchNorm scales and ``batch_stats`` become the weight and the
running statistics, flax's ``OptimizedLSTMCell`` gates become
``torch.nn.LSTM``'s stacked (i, f, g, o) weights, ``DenseGeneral``
attention kernels are packed, and GPT-2's (out, in) kernels are kept.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from amuse_tpu_torch.infer.pipeline import ENCODERS, PipelineParams


def _t(x) -> torch.Tensor:
    """A C-contiguous float32 copy: a transposed kernel keeps no transposed
    strides, which fused optimizers refuse in the Adam moments."""
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


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


# ---- train states (the orbax checkpoints' trees) ----------------------------


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def assert_permutation(mapper, tree: Mapping) -> None:
    """Raise unless ``mapper`` (a flax tree -> {name: tensor}) moves every
    element of ``tree`` to exactly one place of its result, with no sum,
    scale or copy: fed a tree of distinct bit patterns (a uint32 count seen
    as float32; the maps only move bytes), its result must hold each pattern
    once. Such a map carries an Adam second moment, a sum of squares, exactly
    as it carries the parameters."""
    count = 0

    def ids(x):
        nonlocal count
        shape = np.shape(x)
        n = math.prod(shape)
        out = np.arange(count, count + n, dtype=np.uint32).view(np.float32).reshape(shape)
        count += n
        return out

    id_tree = _tree_map(ids, tree)
    if count > np.iinfo(np.uint32).max:
        raise ValueError(f"{count} elements: too many for the permutation check")
    mapped = mapper(id_tree)
    seen, placed = np.zeros(count, bool), 0
    for v in mapped.values():
        bits = v.numpy().view(np.uint32).reshape(-1)
        if bits.size and int(bits.max()) >= count:
            raise AssertionError("the map computes values: an output is no element of its input")
        seen[bits] = True
        placed += bits.size
    if placed != count or not seen.all():
        raise AssertionError(f"the map is no permutation: {count} elements in, {placed} placed, "
                             f"{int(seen.sum())} distinct")


def _prefixed(**maps):
    """{prefix: (flax subtree key, map)} -> one map of a flax tree into
    ``<prefix>.<name>`` keys."""
    def mapper(tree):
        return {f"{pre}.{k}": v for pre, (key, fn) in maps.items()
                for k, v in fn(tree if key is None else tree[key]).items()}
    return mapper


def _train_state_from_jax(tree: Mapping, modules: dict, optimizer: torch.optim.Optimizer,
                          mapper) -> tuple[dict, dict | None, int]:
    """-> (state dict per module, optimizer state dict or None, step).

    ``modules`` ({prefix: module}, on any device, ``meta`` included) are the
    port's, in the optimizer's order of parameters; the parameters and both
    Adam moments go through ``mapper`` (checked to be a permutation). A port
    parameter that the flax tree lacks is left out of the state dicts (the
    train states load without it and keep their own) and gets no optimizer
    state (torch makes it at its first gradient). A tree of bare parameters
    (no ``opt_state``: checkpoints older than the full train state) gives
    None for the optimizer and step 0, as the JAX package's fallback."""
    full = "opt_state" in tree and "params" in tree
    params_tree = tree["params"] if full else tree
    assert_permutation(mapper, params_tree)
    params = mapper(params_tree)
    names = [f"{pre}.{n}" for pre, m in modules.items() for n, _ in m.named_parameters()]
    extra = sorted(set(params) - set(names))
    if extra:
        raise KeyError(f"flax parameters with no counterpart in the port: {extra[:5]}")
    state_dicts = {pre: {k[len(pre) + 1:]: v for k, v in params.items()
                         if k.startswith(pre + ".")} for pre in modules}
    if not full:
        return state_dicts, None, 0
    opt = tree["opt_state"]
    mu, nu = mapper(opt["mu"]), mapper(opt["nu"])
    step = torch.tensor(float(np.asarray(opt["count"])), dtype=torch.float32)
    state = {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
             for i, n in enumerate(names) if n in params}
    groups = optimizer.state_dict()["param_groups"]
    lr = float(np.asarray(opt["lr"]))
    return state_dicts, {"state": state, "param_groups": [{**g, "lr": lr} for g in groups]}, \
        int(np.asarray(tree["step"]))


def audio_train_state_from_jax(tree: Mapping, state) -> dict:
    """A restored JAX stage-1 ``TrainState`` -> the dict that the port's
    ``train.audio.AudioTrainState.load_state_dict`` takes.

    ``tree`` is orbax's template-free restore: ``{"params", "opt_state":
    {"count", "lr", "mu", "nu"}, "step"}`` of numpy arrays, or bare
    parameters. ``state`` is the port's state at the run's widths (its
    modules may live on ``meta``): it gives the order of the optimizer's
    parameters and its hyperparameters. The parameters and both moments go
    through ``disentangler_from_jax``; each parameter's ``step`` is
    ``count`` (torch keeps one per parameter, JAX one), and ``lr`` is the
    JAX state's, which is the schedule's at the last epoch trained:
    ``set_lr`` at the resumed epoch overrides it in both packages.

    One side only: the label heads of the ``frame_based_feats`` branch that
    flax did not trace (``{emo,sty}_enc.mlp_head.*`` by default) are left out
    and have no moments; the resumed state keeps its own. Every flax parameter has a port parameter
    (the positional tables ``pos_embed`` and ``*.pe`` are parameters on both
    sides, decayed alike). Bare parameters give no ``"optimizer"`` key and
    step 0: ``restore_train_state`` then keeps fresh moments.
    """
    sds, opt, step = _train_state_from_jax(
        tree, {"model": state.model}, state.optimizer,
        _prefixed(model=(None, disentangler_from_jax)))
    out = {"model": sds["model"], "step": step}
    if opt is not None:
        out["optimizer"] = opt
    return out


def gesture_train_state_from_jax(tree: Mapping, state) -> dict:
    """A restored JAX LPDM ``TrainState`` (params ``{"prior", "denoiser"}``)
    -> the dict that ``train.gesture.GestureTrainState.load_state_dict``
    takes; as ``audio_train_state_from_jax``, through ``prior_from_jax`` and
    ``denoiser_from_jax``, with the optimizer's order the prior's parameters
    then the denoiser's. The two trees cover the same parameters (no
    parameter is on one side only); ``lr`` is the constant learning rate."""
    sds, opt, step = _train_state_from_jax(
        tree, {"prior": state.prior, "denoiser": state.denoiser}, state.optimizer,
        _prefixed(prior=("prior", prior_from_jax), denoiser=("denoiser", denoiser_from_jax)))
    out = {"params": sds, "step": step}
    if opt is not None:
        out["optimizer"] = opt
    return out


# ---- the legacy model zoo ---------------------------------------------------


def _conv(p: Mapping, out: dict, prefix: str) -> None:
    """flax ``Conv``/``ConvTranspose`` kernel (*spatial, in, out) -> torch (out, in, *spatial)."""
    k = np.asarray(p["kernel"])
    out[f"{prefix}.weight"] = _t(np.transpose(k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _embed(p: Mapping, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(p["embedding"])


def _batchnorm(p: Mapping, stats: Mapping, out: dict, prefix: str) -> None:
    _layernorm(p, out, prefix)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])


def _dense_general_mha(p: Mapping, out: dict, prefix: str) -> None:
    """flax ``MultiHeadDotProductAttention`` (DenseGeneral kernels (in, heads,
    hd) and (heads, hd, out)) -> the packed ``MultiHeadAttention`` keys."""
    names = ("query", "key", "value")
    w = [np.asarray(p[n]["kernel"]) for n in names]
    out[f"{prefix}.in_proj_weight"] = _t(np.concatenate([x.reshape(x.shape[0], -1).T for x in w]))
    out[f"{prefix}.in_proj_bias"] = _t(np.concatenate([np.asarray(p[n]["bias"]).reshape(-1)
                                                        for n in names]))
    k = np.asarray(p["out"]["kernel"])
    out[f"{prefix}.out_proj.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    out[f"{prefix}.out_proj.bias"] = _t(p["out"]["bias"])


def _numbered(p: Mapping, stem: str) -> int:
    return sum(1 for k in p if k.startswith(stem) and k[len(stem):].isdigit())


def _raw_denoiser(p, s, out, pre):
    _linear(p["pose_embd"], out, f"{pre}pose_embd")
    _linear(p["time_mlp"]["linear_1"], out, f"{pre}time_mlp.linear_1")
    _linear(p["time_mlp"]["linear_2"], out, f"{pre}time_mlp.linear_2")
    for name in ("proj_con", "proj_emo"):
        if name in p:
            _linear(p[name], out, f"{pre}{name}")
    out[f"{pre}pos.pe"] = _pos(p["pos"]["pe"])
    for i in range(_numbered(p, "layer_")):
        _layer(p[f"layer_{i}"], out, f"{pre}layers.{i}")
    _linear(p["pose_proj"], out, f"{pre}pose_proj")


def _conv_encoder(p, s, out, pre):
    for i in range(_numbered(p, "conv_")):
        _conv(p[f"conv_{i}"], out, f"{pre}convs.{i}")
    _linear(p["head"], out, f"{pre}head")


def _conv_decoder(p, s, out, pre):
    _linear(p["in"], out, f"{pre}inp")
    for i in range(_numbered(p, "deconv_")):
        _conv(p[f"deconv_{i}"], out, f"{pre}deconvs.{i}")
    _conv(p["out"], out, f"{pre}out")


def _audio_ae(p, s, out, pre):
    """EmotionNet, AutoEncoder2x and AutoEncoder3x: whichever parts the tree holds."""
    for name in ("enc", "con_enc", "emo_enc", "sty_enc"):
        if name in p:
            _conv_encoder(p[name], {}, out, f"{pre}{name}.")
    if "dec" in p:
        _conv_decoder(p["dec"], {}, out, f"{pre}dec.")
    for name in ("cls", "emo_cls", "sty_cls"):
        if name in p:
            _linear(p[name], out, f"{pre}{name}")


def _tcn(p, s, out, pre):
    for i in range(_numbered(p, "block_")):
        b, bp = p[f"block_{i}"], f"{pre}blocks.{i}"
        for name in ("conv1", "conv2", "downsample"):
            if name in b:
                _conv(b[name], out, f"{bp}.{name}")


def _basic_block(p, s, out, pre):
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn")):
        if conv in p:
            _conv(p[conv], out, f"{pre}{conv}")
            _batchnorm(p[bn], s[bn], out, f"{pre}{bn}")


def _facenet(p, s, out, pre):
    for i in range(_numbered(p, "b")):
        _basic_block(p[f"b{i}"], s[f"b{i}"], out, f"{pre}b{i}.")


def _audio_net(p, s, out, pre):
    if "tcn" in p:
        _tcn(p["tcn"], {}, out, f"{pre}tcn.")
    _linear(p["proj"], out, f"{pre}proj")


def _fusion(p, s, out, pre):
    _linear(p["fc1"], out, f"{pre}fc1")
    _linear(p["fc2"], out, f"{pre}fc2")


def _emotion_addon(p, s, out, pre):
    _embed(p["embed"], out, f"{pre}embed")
    _linear(p["fc"], out, f"{pre}fc")
    for i in range(_numbered(p, "conv")):
        _conv(p[f"conv{i}"], out, f"{pre}convs.{i}")
        _batchnorm(p[f"bn{i}"], s[f"bn{i}"], out, f"{pre}bns.{i}")


def _speaker_addon(p, s, out, pre):
    _embed(p["embed"], out, f"{pre}embed")
    _linear(p["fc"], out, f"{pre}fc")


def _lstm(p: Mapping, out: dict, prefix: str, i: int) -> None:
    """flax ``OptimizedLSTMCell`` (input kernels ii/if/ig/io without bias,
    hidden kernels hi/hf/hg/ho with it) -> layer i of ``torch.nn.LSTM``."""
    gates = "ifgo"
    out[f"{prefix}.weight_ih_l{i}"] = _t(np.concatenate([np.asarray(p[f"i{g}"]["kernel"]).T
                                                          for g in gates]))
    out[f"{prefix}.weight_hh_l{i}"] = _t(np.concatenate([np.asarray(p[f"h{g}"]["kernel"]).T
                                                          for g in gates]))
    out[f"{prefix}.bias_hh_l{i}"] = _t(np.concatenate([np.asarray(p[f"h{g}"]["bias"])
                                                        for g in gates]))
    out[f"{prefix}.bias_ih_l{i}"] = torch.zeros_like(out[f"{prefix}.bias_hh_l{i}"])


def _camn(p, s, out, pre):
    _audio_net(p["audio_net"], {}, out, f"{pre}audio_net.")
    if "txt_proj" in p:
        _linear(p["txt_proj"], out, f"{pre}txt_proj")
    if "emo_addon" in p:
        _emotion_addon(p["emo_addon"], s["emo_addon"], out, f"{pre}emo_addon.")
    if "spk_addon" in p:
        _speaker_addon(p["spk_addon"], {}, out, f"{pre}spk_addon.")
    _fusion(p["fusion"], {}, out, f"{pre}fusion.")
    for i in range(_numbered(p, "OptimizedLSTMCell_")):
        _lstm(p[f"OptimizedLSTMCell_{i}"], out, f"{pre}lstm", i)
    _linear(p["head1"], out, f"{pre}head1")
    _linear(p["head2"], out, f"{pre}head2")


def _faceformer(p, s, out, pre):
    _linear(p["audio_feature_map"], out, f"{pre}audio_feature_map")
    _embed(p["obj_vector"], out, f"{pre}obj_vector")
    if "emo_vector" in p:
        _embed(p["emo_vector"], out, f"{pre}emo_vector")
    _linear(p["vertice_map"], out, f"{pre}vertice_map")
    for i in range(_numbered(p, "ln1_")):
        lp = f"{pre}layers.{i}"
        for name in ("ln1", "ln2", "ln3"):
            _layernorm(p[f"{name}_{i}"], out, f"{lp}.{name}")
        for name in ("self_qkv", "self_proj", "ff1", "ff2"):
            _linear(p[f"{name}_{i}"], out, f"{lp}.{name}")
        _dense_general_mha(p[f"cross_attn_{i}"], out, f"{lp}.cross_attn")
    _linear(p["vertice_map_r"], out, f"{pre}vertice_map_r")


def _text_encoder(p, s, out, pre):
    """flax GPT-2 stores ``c_attn``/``c_proj``/``c_fc`` kernels (out, in): torch's layout."""
    bb, bp = p["backbone"], f"{pre}backbone"
    _embed(bb["wte"], out, f"{bp}.wte")
    _embed(bb["wpe"], out, f"{bp}.wpe")
    for i in range(len(bb["h"])):
        h, hp = bb["h"][str(i)], f"{bp}.h.{i}"
        _layernorm(h["ln_1"], out, f"{hp}.ln_1")
        _layernorm(h["ln_2"], out, f"{hp}.ln_2")
        for sub, name in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                          ("mlp", "c_proj")):
            out[f"{hp}.{sub}.{name}.weight"] = _t(h[sub][name]["kernel"])
            out[f"{hp}.{sub}.{name}.bias"] = _t(h[sub][name]["bias"])
    _layernorm(bb["ln_f"], out, f"{bp}.ln_f")
    _linear(p["proj"], out, f"{pre}proj")


def _discriminator(p, s, out, pre):
    for i in range(_numbered(p, "conv")):
        _conv(p[f"conv{i}"], out, f"{pre}convs.{i}")
    _linear(p["out"], out, f"{pre}out")


def _actor(p, s, out, pre):
    """ActorAE; its decoder exists in the flax tree only when init ran ``decode``."""
    enc = p["encoder"]
    _linear(enc["skel_embedding"], out, f"{pre}encoder.skel_embedding")
    out[f"{pre}encoder.mu_query"] = _t(enc["mu_query"])
    for i in range(_numbered(enc, "layer_")):
        _layer(enc[f"layer_{i}"], out, f"{pre}encoder.layers.{i}")
    if "decoder" in p:
        dec = p["decoder"]
        for i in range(_numbered(dec, "layer_")):
            _layer(dec[f"layer_{i}"], out, f"{pre}decoder.layers.{i}")
        _linear(dec["final"], out, f"{pre}decoder.final")
    for name in ("cls_fc1", "cls_fc2", "cls_out"):
        _linear(p[name], out, f"{pre}{name}")


_LEGACY = {
    # the registry's legacy tags
    "diffusion": _raw_denoiser, "wav_mfcc": _audio_ae, "camn_lstm": _camn,
    "faceformer": _faceformer, "txt_gpt2": _text_encoder, "discriminator": _discriminator,
    "actor_ae": _actor,
    # the members' parts, by class name
    "RawPoseDenoiser": _raw_denoiser, "EmotionNet": _audio_ae, "AutoEncoder2x": _audio_ae,
    "AutoEncoder3x": _audio_ae, "ConvEncoder": _conv_encoder, "ConvDecoder": _conv_decoder,
    "TemporalConvNet": _tcn, "ConvBasicBlock": _basic_block, "FaceNet": _facenet,
    "AudioNet": _audio_net, "FusionNet": _fusion, "EmotionAddon": _emotion_addon,
    "SpeakerAddon": _speaker_addon, "CaMNPoseGenerator": _camn,
    "FaceformerDecoder": _faceformer, "TextEncoder": _text_encoder,
    "ConvDiscriminator": _discriminator, "ActorAE": _actor,
}


def legacy_from_jax(tag: str, variables: Mapping) -> dict:
    """A legacy zoo member's flax variables -> the port's state dict.

    ``tag``: a registry tag of the legacy family (``diffusion``, ``wav_mfcc``,
    ``camn_lstm``, ``faceformer``, ``txt_gpt2``, ``discriminator``,
    ``actor_ae``) or the class name of a member or part (``AutoEncoder2x``,
    ``FaceNet``, ...). ``variables``: ``{"params": ..., "batch_stats": ...}``
    as ``Module.init`` returns it, or the params tree alone (a
    ``RawTrainState``'s ``params``), as numpy arrays. The BatchNorm running
    statistics come from ``batch_stats``. Submodules that the flax tree does
    not hold (flax creates them at their first call) are absent from the
    result.
    """
    if tag not in _LEGACY:
        raise KeyError(f"no legacy converter for {tag!r}; known: {sorted(_LEGACY)}")
    params = variables["params"] if "params" in variables else variables
    out: dict = {}
    _LEGACY[tag](params, variables.get("batch_stats", {}), out, "")
    return out
