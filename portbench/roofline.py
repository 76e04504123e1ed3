"""Peaks of the card and the operations and bytes of the measured work,
counted from shapes (the same work whatever implements it).

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at 700 W: 989 TFLOP/s
on bf16 tensor cores, 67 TFLOP/s in float32 outside the tensor cores, and
3.35 TB/s of HBM3. A share of a peak is stated against these whatever the
card's power limit; the result line carries the card's name.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def vit_tokens(ast: dict) -> int:
    f = (ast["input_fdim"] - ast["patch"]) // ast["fstride"] + 1
    t = (ast["input_tdim"] - ast["patch"]) // ast["tstride"] + 1
    return f * t + 2  # cls and distillation tokens


def vit_forward_flops(ast: dict) -> float:
    """One AST encoder over one fbank: the patch projection, per block the
    qkv, output, and MLP products (24 E^2 per token at MLP ratio 4) and the
    two attention products QK^T and PV (2 S^2 E each), and the feature head."""
    s, e, depth = vit_tokens(ast), ast["embed_dim"], ast["depth"]
    hidden = e * ast["mlp_ratio"]
    dense = s * depth * 2 * (3 * e * e + e * e + 2 * e * hidden)
    attn = depth * 2 * (2 * s * s * e)
    patch = (s - 2) * 2 * ast["patch"] * ast["patch"] * e
    head = 2 * e * ast["feature_dim"]
    return float(dense + attn + patch + head)


def _layer_flops(t: int, d: int, ff: int, memory: int = 0) -> float:
    """A post-norm layer over t tokens of width d (self-attention, with
    ``memory`` tokens a cross-attention too, and the FFN)."""
    self_attn = 2 * t * 4 * d * d + 4 * t * t * d
    cross = 0 if not memory else 2 * t * 2 * d * d + 2 * memory * 2 * d * d + 4 * t * memory * d
    return float(self_attn + cross + 2 * t * 2 * d * ff)


def skip_stack_flops(t: int, d: int, ff: int, layers: int, memory: int = 0) -> float:
    merges = (layers - 1) // 2 * 2 * t * 2 * d * d
    return layers * _layer_flops(t, d, ff, memory) + merges


def sampler_flops(den: dict, windows: int, steps: int, cond_tokens: int = 3) -> float:
    """The DDIM loop of ``windows`` windows: per step one denoiser pass over
    2 + cond_tokens tokens (latent, time, conditions)."""
    t = 2 + cond_tokens
    return float(windows * steps * skip_stack_flops(t, den["latent_dim"], den["ff_size"],
                                                     den["num_layers"]))


def sampler_bytes(den: dict, windows: int, cond_tokens: int = 3) -> float:
    """Bytes the loop must move at least, float32: the denoiser's layer
    weights once, each window's condition tokens and latent in, latent out."""
    d, ff, layers = den["latent_dim"], den["ff_size"], den["num_layers"]
    weights = layers * (4 * d * d + 4 * d + 2 * d * ff + ff + d + 4 * d) \
        + (layers - 1) // 2 * (2 * d * d + d) + 2 * d
    return float(4 * (weights + windows * (cond_tokens * d + 2 * d)))


def decode_flops(prior: dict) -> float:
    """The prior's decoder over one window: the skip stack over ``window``
    queries cross-attending the latent, and the final projection."""
    t, d = prior["window"], prior["latent_dim"]
    stack = skip_stack_flops(t, d, prior["ff_size"], prior["num_layers"],
                             memory=prior["latent_tokens"])
    return float(stack + 2 * t * d * prior["nfeats"])


def infer_window_flops(cfg: dict) -> float:
    """Model FLOPs of one 10 s window through the inference stack: the AST
    encoders, the DDIM loop and the decode (fbank and rotations left out)."""
    enc = len(cfg["ast"]["encoders"])
    steps = cfg["diffusion"]["num_inference_steps"]
    return (enc * vit_forward_flops(cfg["ast"]) + sampler_flops(cfg["denoiser"], 1, steps, enc)
            + decode_flops(cfg["prior"]))


def attention_fwd_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """QK^T and PV of a non-causal attention forward."""
    return float(4 * batch * heads * seq * seq * head_dim)


def attention_fwd_bytes(batch: int, heads: int, seq: int, head_dim: int, dtype: str) -> float:
    """q, k and v read once and o written once."""
    return float(4 * batch * heads * seq * head_dim * DTYPE_BYTES[dtype])


def attention_bwd_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """The backward from the row log-sum-exp: S = QK^T and dP = dO V^T again,
    dQ = dS K, dK = dS^T Q, dV = P^T dO: five products of 2 S^2 D."""
    return float(10 * batch * heads * seq * seq * head_dim)


def attention_bwd_bytes(batch: int, heads: int, seq: int, head_dim: int, dtype: str) -> float:
    """q, k, v, o, dO and the row log-sum-exp read once, dq, dk, dv written once."""
    return float(batch * heads * seq * (8 * head_dim * DTYPE_BYTES[dtype] + 4))


def _stack_flops(groups: int, length: int, width: int, layers: int, ff: int) -> float:
    """``groups`` sequences of ``length`` through post-norm layers of ``width``."""
    per_layer = 2 * length * 4 * width * width + 4 * length * length * width \
        + 2 * length * 2 * width * ff
    return float(groups * layers * per_layer)


def stage1_forward_flops(cfg: dict, quads: int) -> float:
    """One forward of the stage-1 step over ``quads`` quads: three encoders
    over the 4 quads' members, the label heads, and the 16 swap combinations
    through the fusion and the decoder, which attend across the batch (16
    sequences of ``quads``)."""
    a, s = cfg["ast"], cfg["stage1"]
    members, fd, fu = 4 * quads, a["feature_dim"], s["fusion_dim"]
    encoders = 3 * members * vit_forward_flops(a)
    heads = 2 * members * a["embed_dim"] * sum(s["label_dims"].values())
    fusion = _stack_flops(16, quads, 3 * fd, s["fusion_layers"], s["ff_size"]) \
        + 16 * quads * 2 * 3 * fd * fu
    frames = a["input_tdim"] * a["input_fdim"]
    decoder = _stack_flops(16, quads, fu, s["decoder_layers"], s["ff_size"]) \
        + 16 * quads * (2 * fu * 2 * fu + 2 * 2 * fu * frames)
    return float(encoders + heads + fusion + decoder)


def stage1_step_flops(cfg: dict, quads: int) -> float:
    """The step: the forward and twice it for the backward."""
    return 3.0 * stage1_forward_flops(cfg, quads)


def roofline_pct(flops: float, nbytes: float, seconds: float, dtype: str) -> float:
    """The least time the card could take (the larger of operations over the
    peak for ``dtype`` and bytes over the HBM peak) as a share of ``seconds``."""
    bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
    return 100.0 * bound / seconds
