"""Plain reference of AMUSE's stage-1 train step (``train_audio``), float32
with TF32 off.

One step over B quads (actor 1, actor 2) x (take 1, take 2) of clean
fbanks: the 4B members stacked member-major, SpecAugment (a frequency band
then a time band, widths uniform below the mask sizes, starts uniform over
what is left; the masked fbank is the target) and noise (uniform noise of a
per-member amplitude in [0, 0.1), rolled along time by a shift in [-10, 10))
drawn in that order from the step's generator; the three AST encoders
(emotion, style, content; ViT-B/16 as in ``infer.py``) with the label heads
on the mean of the class and distillation outputs; the 16 [emotion | style |
content] swap combinations through the fusion (two post-norm ReLU layers of
4 heads and 2,048, LayerNorm, Linear) and the decoder (four such layers,
LayerNorm, Linear, ReLU, Linear to the fbank), both attending across the
batch, with dropout 0.1 on the attention weights, each branch and the
feed-forward activation, drawn from the same generator in the order the
layers run; 16 L1 reconstruction terms, cross-entropy of the emotion and
speaker logits, and the content alignment L1; then Adam with the L2 decay
added to the gradient (PyTorch's ``Adam(weight_decay=)``). The label heads
on the feature, which the loss does not reach, take no step; every other
parameter does, with a zero gradient where the loss does not reach it.

The ViT blocks are recomputed in the backward (``torch.utils.checkpoint``)
so that float32 fits beside nothing else on one card, in blocks of
``MEMBERS_PER_BLOCK`` members, so that a global batch of several cards'
steps fits too. ``precision="control"``
rounds both operands of every product that the configuration runs in bf16
to fp8 e4m3 (per-tensor scales), in the forward and in the backward's
products, whose incoming gradient is rounded too. Nothing here imports the
program.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.infer import _fp8, encoder_shapes, num_patches

ENCODERS = ("emo", "sty", "con")
# the loss's terms, as the program's train step logs them
TERMS = ("recon", "ce_emo", "ce_sty", "con_align", "total")
# A leaf whose step-1 gradient norm is under LEAF_BELOW of the median
# leaf's is not compared: the loss does not reach it (the fusion ablation).
LEAF_BELOW = 1e-3
# An element whose step-1 gradient is under ELEMENT_BELOW of the median
# leaf's root mean square is left out of the change: float32 rounding's
# reach. A key's bias under softmax (the key third of each fused qkv or
# in_proj bias) has a gradient nought in exact arithmetic; in float32 it
# reads up to 4.6e-7 of that, and Adam, which scales every step to about
# lr, moves it by rounding alone. The floor also takes the exactly nought
# gradients of ReLU units that no token of the step reaches.
ELEMENT_BELOW = 1e-6
# The members a ViT block takes at once: one stage1.q8 step's (8 quads of 4
# fbanks), so that a larger batch runs as blocks of that size.
MEMBERS_PER_BLOCK = 32


def _stack_keys(prefix: str, d: int, layers: int, ff: int) -> dict:
    keys = {}
    for i in range(layers):
        p = f"{prefix}.layers.{i}"
        keys.update({f"{p}.self_attn.in_proj_weight": (3 * d, d),
                     f"{p}.self_attn.in_proj_bias": (3 * d,),
                     f"{p}.self_attn.out_proj.weight": (d, d), f"{p}.self_attn.out_proj.bias": (d,),
                     f"{p}.linear1.weight": (ff, d), f"{p}.linear1.bias": (ff,),
                     f"{p}.linear2.weight": (d, ff), f"{p}.linear2.bias": (d,),
                     f"{p}.norm1.weight": (d,), f"{p}.norm1.bias": (d,),
                     f"{p}.norm2.weight": (d,), f"{p}.norm2.bias": (d,)})
    keys.update({f"{prefix}.norm.weight": (d,), f"{prefix}.norm.bias": (d,)})
    return keys


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """{key: shape} of the stage-1 model (reference ``AST_EVP`` keys)."""
    a, s = cfg["ast"], cfg["stage1"]
    e, fd, fu, ff = a["embed_dim"], a["feature_dim"], s["fusion_dim"], s["ff_size"]
    shapes = {}
    for name in ENCODERS:
        enc = encoder_shapes(a)
        labels = s["label_dims"].get(name, 0)
        if labels:
            enc.update({"mlp_head.0.weight": (fd,), "mlp_head.0.bias": (fd,),
                        "mlp_head.1.weight": (labels, fd), "mlp_head.1.bias": (labels,),
                        "mlp_head_featbased.0.weight": (e,), "mlp_head_featbased.0.bias": (e,),
                        "mlp_head_featbased.1.weight": (labels, e),
                        "mlp_head_featbased.1.bias": (labels,)})
        shapes.update({f"{name}_enc.{k}": v for k, v in enc.items()})
    for prefix, width in (("fusion", 3 * fd), ("fusion_ablation", 2 * fd)):
        shapes.update(_stack_keys(prefix, width, s["fusion_layers"], ff))
        shapes.update({f"{prefix}.fc.weight": (fu, width), f"{prefix}.fc.bias": (fu,)})
    shapes.update(_stack_keys("decode", fu, s["decoder_layers"], ff))
    frames = a["input_tdim"] * a["input_fdim"]
    shapes.update({"decode.projection.0.weight": (2 * fu, fu),
                   "decode.projection.0.bias": (2 * fu,),
                   "decode.projection.2.weight": (frames, 2 * fu),
                   "decode.projection.2.bias": (frames,)})
    return shapes


def counted_leaves(raw1: dict) -> list:
    """The leaves compared: those whose step-1 gradient norm is at least
    LEAF_BELOW of the median leaf's."""
    median = statistics.median(raw1.values())
    return sorted(k for k, v in raw1.items() if v >= LEAF_BELOW * median)


def kept_elements(grads: dict, raw1: dict) -> dict:
    """{key: the elements whose step-1 gradient is at least ELEMENT_BELOW of
    the median leaf's root mean square}."""
    floor = ELEMENT_BELOW * statistics.median(raw1[k] / math.sqrt(g.numel())
                                              for k, g in grads.items())
    return {k: g.abs() >= floor for k, g in grads.items()}


def untraced(name: str) -> bool:
    """The label heads on the feature: the loss never reaches them, and the
    step leaves them as they are (frame-based features use the others)."""
    return "_enc.mlp_head." in name


def spec_augment(g: torch.Generator, fb: torch.Tensor, freq_mask: int, time_mask: int,
                 noise: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, T, F) -> (target, model input), drawing as the docstring above says."""
    n, t_len, f_len = fb.shape
    dev = fb.device

    def band(length: int, mask: int) -> torch.Tensor:
        width = torch.randint(0, max(mask, 1), (n,), generator=g, device=dev)
        start = (torch.rand(n, generator=g, device=dev) * (length - width + 1)).floor().long()
        ar = torch.arange(length, device=dev)
        return (ar >= start[:, None]) & (ar < (start + width)[:, None])

    fb = fb.masked_fill(band(f_len, freq_mask)[:, None, :] | band(t_len, time_mask)[:, :, None],
                        0.0)
    if not noise:
        return fb, fb
    amp = torch.rand((n, 1, 1), generator=g, device=dev)
    noisy = fb + torch.rand((n, t_len, f_len), generator=g, device=dev) * amp / 10.0
    shift = torch.randint(-10, 10, (n,), generator=g, device=dev)
    src = (torch.arange(t_len, device=dev)[None, :] - shift[:, None]) % t_len
    return fb, noisy.gather(1, src[:, :, None].expand(-1, -1, f_len))


def _sum_to(grad: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``grad`` summed over the dimensions that broadcasting added to ``shape``."""
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    return grad.sum([i for i, n in enumerate(shape) if n == 1 and grad.shape[i] != 1],
                    keepdim=True) if grad.shape != shape else grad


class _Fp8MatMul(torch.autograd.Function):
    """x @ y on fp8 e4m3 operands (per-tensor scales), forward and backward:
    the backward's two products take the incoming gradient in fp8 too."""

    @staticmethod
    def forward(ctx, x, y):
        qx, qy = _fp8(x), _fp8(y)
        ctx.save_for_backward(qx, qy)
        ctx.shapes = (x.shape, y.shape)
        return qx @ qy

    @staticmethod
    def backward(ctx, g):
        qx, qy = ctx.saved_tensors
        qg = _fp8(g)
        return (_sum_to(qg @ qy.transpose(-1, -2), ctx.shapes[0]),
                _sum_to(qx.transpose(-1, -2) @ qg, ctx.shapes[1]))


class Stage1:
    """The loss and the Adam steps of one configuration, over a dict of
    float32 parameters under the keys of ``param_shapes``."""

    def __init__(self, cfg: dict, device: torch.device, precision: str = "float32"):
        if precision not in ("float32", "control"):
            raise ValueError(f"precision must be float32 or control, got {precision!r}")
        self.cfg, self.device, self.control = cfg, device, precision == "control"

    @contextlib.contextmanager
    def _no_tf32(self):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def _mm(self, x, y):
        return _Fp8MatMul.apply(x, y) if self.control else x @ y

    def _linear(self, x, w, b):
        return self._mm(x, w.transpose(-1, -2)) + b

    # -- the encoders ---------------------------------------------------------

    def _block(self, x, *w):
        n, s, e = x.shape
        heads = self.cfg["ast"]["num_heads"]
        (n1w, n1b, qkv_w, qkv_b, pw, pb, n2w, n2b, f1w, f1b, f2w, f2b) = w
        h = F.layer_norm(x, (e,), n1w, n1b, 1e-6)
        q, k, v = self._linear(h, qkv_w, qkv_b).view(n, s, 3, heads, e // heads).permute(
            2, 0, 3, 1, 4)
        att = torch.softmax(self._mm(q, k.transpose(-1, -2)) / math.sqrt(e // heads), -1)
        x = x + self._linear(self._mm(att, v).transpose(1, 2).reshape(n, s, e), pw, pb)
        h = F.gelu(self._linear(F.layer_norm(x, (e,), n2w, n2b, 1e-6), f1w, f1b))
        return x + self._linear(h, f2w, f2b)

    def _blocks(self, x, w):
        """One ViT block over the members, recomputed in the backward, in
        blocks of ``MEMBERS_PER_BLOCK`` members (a block treats each member
        alone, so only the memory it takes changes)."""
        parts = [checkpoint(self._block, part, *w, use_reentrant=False)
                 for part in x.split(MEMBERS_PER_BLOCK)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def encode(self, P: dict, name: str, spec: torch.Tensor):
        """(N, T, F) -> (feature (N, fd), label logits (N, L) or None)."""
        a, p = self.cfg["ast"], f"{name}_enc."
        e, patch, n = a["embed_dim"], a["patch"], spec.shape[0]
        x = spec.transpose(-1, -2).unfold(1, patch, a["fstride"]).unfold(2, patch, a["tstride"])
        x = self._linear(x.reshape(n, num_patches(a), patch * patch),
                         P[p + "v.patch_embed.proj.weight"].reshape(e, -1),
                         P[p + "v.patch_embed.proj.bias"])
        x = torch.cat([P[p + "v.cls_token"].expand(n, 1, e), P[p + "v.dist_token"].expand(n, 1, e),
                       x], 1) + P[p + "v.pos_embed"]
        for i in range(a["depth"]):
            b = f"{p}v.blocks.{i}."
            w = [P[b + k] for k in ("norm1.weight", "norm1.bias", "attn.qkv.weight",
                                     "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                                     "norm2.weight", "norm2.bias", "mlp.fc1.weight",
                                     "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")]
            x = self._blocks(x, w)
        x = F.layer_norm(x, (e,), P[p + "v.norm.weight"], P[p + "v.norm.bias"], 1e-6)
        x_dist = 0.5 * (x[:, 0] + x[:, 1])
        h = F.layer_norm(x[:, 2:].mean(1), (e,), P[p + "feature_head.0.weight"],
                         P[p + "feature_head.0.bias"], 1e-5)
        feature = self._linear(h, P[p + "feature_head.1.weight"], P[p + "feature_head.1.bias"])
        if p + "mlp_head_featbased.1.weight" not in P:
            return feature, None
        h = F.layer_norm(x_dist, (e,), P[p + "mlp_head_featbased.0.weight"],
                         P[p + "mlp_head_featbased.0.bias"], 1e-5)
        return feature, self._linear(h, P[p + "mlp_head_featbased.1.weight"],
                                     P[p + "mlp_head_featbased.1.bias"])

    # -- the fusion and the decoder ---------------------------------------------

    def _layer(self, P, p, x, g, rate):
        def drop(y):
            keep = torch.rand(y.shape, generator=g, device=y.device) >= rate
            return torch.where(keep, y / (1.0 - rate), torch.zeros((), device=y.device))

        heads, d = self.cfg["stage1"]["heads"], x.shape[-1]
        wq, wk, wv = P[p + "self_attn.in_proj_weight"].chunk(3)
        bq, bk, bv = P[p + "self_attn.in_proj_bias"].chunk(3)

        def split(t):
            return t.reshape(t.shape[:-1] + (heads, d // heads)).transpose(-3, -2)

        q, k, v = (split(self._linear(x, w, b)) for w, b in ((wq, bq), (wk, bk), (wv, bv)))
        att = drop(torch.softmax(self._mm(q, k.transpose(-1, -2)) / math.sqrt(d // heads), -1))
        o = self._mm(att, v).transpose(-3, -2).reshape(x.shape)
        o = drop(self._linear(o, P[p + "self_attn.out_proj.weight"],
                              P[p + "self_attn.out_proj.bias"]))
        x = F.layer_norm(x + o, (d,), P[p + "norm1.weight"], P[p + "norm1.bias"], 1e-5)
        h = drop(F.relu(self._linear(x, P[p + "linear1.weight"], P[p + "linear1.bias"])))
        h = drop(self._linear(h, P[p + "linear2.weight"], P[p + "linear2.bias"]))
        return F.layer_norm(x + h, (d,), P[p + "norm2.weight"], P[p + "norm2.bias"], 1e-5)

    def _trunk(self, P, prefix, x, layers, g):
        rate = self.cfg["stage1"]["dropout"]
        for i in range(layers):
            x = self._layer(P, f"{prefix}.layers.{i}.", x, g, rate)
        return F.layer_norm(x, x.shape[-1:], P[prefix + ".norm.weight"], P[prefix + ".norm.bias"],
                            1e-5)

    def reconstruct(self, P, stack, g):
        """(16, B, 3 fd) -> (16, B, T, F)."""
        s, a = self.cfg["stage1"], self.cfg["ast"]
        h = self._linear(self._trunk(P, "fusion", stack, s["fusion_layers"], g),
                         P["fusion.fc.weight"], P["fusion.fc.bias"])
        h = self._trunk(P, "decode", h, s["decoder_layers"], g)
        h = F.relu(self._linear(h, P["decode.projection.0.weight"], P["decode.projection.0.bias"]))
        h = self._linear(h, P["decode.projection.2.weight"], P["decode.projection.2.bias"])
        return h.reshape(h.shape[:-1] + (a["input_tdim"], a["input_fdim"]))

    # -- the loss -------------------------------------------------------------

    def loss(self, P: dict, batch: dict, g: torch.Generator) -> dict:
        """-> {term: scalar tensor} of ``TERMS``; "total" is their sum."""
        tr = self.cfg["train"]
        clean = batch["fbanks"]
        b, _, t_len, f_len = clean.shape
        quad = clean.transpose(0, 1).reshape(4 * b, t_len, f_len)
        target, flat = spec_augment(g, quad, tr["freq_mask"], tr["time_mask"], tr["noise_aug"])
        enc = {name: self.encode(P, name, flat) for name in ENCODERS}
        f_emo, f_sty, f_con = (enc[k][0].view(4, b, -1) for k in ENCODERS)
        ident = torch.arange(4, device=clean.device)
        partner, other = (ident + 2) % 4, ident ^ 1

        def combos(e, s, c):
            return torch.cat([f_emo[e], f_sty[s], f_con[c]], dim=-1)

        stack = torch.cat([combos(ident, ident, ident), combos(ident, ident, partner),
                           combos(other, ident, ident), combos(ident, other, ident)])
        recons = self.reconstruct(P, stack, g)
        targets = target.view(4, b, t_len, f_len).repeat(4, 1, 1, 1)
        emo_logits = enc["emo"][1].view(4, b, -1)
        sty_logits = enc["sty"][1].view(4, b, -1)
        sty_labels = (batch["a1_id"], batch["a1_id"], batch["a2_id"], batch["a2_id"])
        out = {"recon": (recons - targets).abs().mean(dim=(1, 2, 3)).sum(),
               "ce_emo": sum(F.cross_entropy(emo_logits[i], batch["emo_id"]) for i in range(4)),
               "ce_sty": sum(F.cross_entropy(sty_logits[i], sty_labels[i]) for i in range(4)),
               "con_align": ((f_con[0] - f_con[2]).abs().mean()
                             + (f_con[1] - f_con[3]).abs().mean())}
        out["total"] = out["recon"] + out["ce_emo"] + out["ce_sty"] + out["con_align"]
        return out

    # -- Adam -----------------------------------------------------------------

    def steps(self, weights: dict, batches: list, generators: list,
              kept: dict | None = None) -> dict:
        """Adam steps from ``weights`` over ``batches`` with ``generators`` ->
        {"losses": [{term: value}, ...], "grad1": {key: |g + wd p| of step
        1}, "raw1": {key: |g| of step 1}, "kept": {key: ``kept_elements``},
        "change": {key: |p_n - p_0| over the kept elements}}. ``kept``
        (another run's) takes the place of this run's own for the change."""
        tr = self.cfg["train"]
        lr, (b1, b2), eps, wd = tr["learning_rate"], tr["betas"], tr["eps"], tr["weight_decay"]
        P = {k: v.detach().to(self.device, torch.float32).clone().requires_grad_(not untraced(k))
             for k, v in weights.items()}
        start = {k: v.detach().clone() for k, v in P.items()}
        m = {k: torch.zeros_like(v) for k, v in P.items()}
        v2 = {k: torch.zeros_like(v) for k, v in P.items()}
        out = {"losses": [], "grad1": {}, "raw1": {}, "kept": {}, "change": {}}
        with self._no_tf32():
            for t, (batch, g) in enumerate(zip(batches, generators), 1):
                terms = self.loss(P, batch, g)
                traced = [k for k in P if not untraced(k)]
                grads = torch.autograd.grad(terms["total"], [P[k] for k in traced],
                                            allow_unused=True)
                out["losses"].append({t: v.item() for t, v in terms.items()})
                grads = {k: torch.zeros_like(P[k]) if grad is None else grad
                         for k, grad in zip(traced, grads)}
                with torch.no_grad():
                    if t == 1:
                        out["raw1"] = {k: float(grad.norm()) for k, grad in grads.items()}
                        out["kept"] = kept_elements(grads, out["raw1"])
                    for k, grad in grads.items():
                        grad = grad + wd * P[k]
                        if t == 1:
                            out["grad1"][k] = float(grad.norm())
                        m[k].mul_(b1).add_(grad, alpha=1 - b1)
                        v2[k].mul_(b2).addcmul_(grad, grad, value=1 - b2)
                        denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                        P[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
                del terms, grads
        out["change"] = {k: float((P[k].detach() - start[k])[mask].norm())
                         for k, mask in (kept or out["kept"]).items()}
        return out
