"""Plain reference of AMUSE's frozen inference stack, float32 with TF32 off.

Speech windows -> Kaldi fbank -> three AST encoders (content, emotion,
style; ViT-B/16 over overlapping 16x16 patches of a 1024 x 128 fbank,
stride 10, cls and distillation tokens, pre-norm blocks, exact GELU, mean of
the patch tokens, LayerNorm + Linear feature head) -> 50-step eta=0 DDIM
(diffusers' DDIMScheduler: scaled-linear betas, "leading" spacing with
offset 1, alphas_cumprod[0] as the final alpha, pred-x0 clipped to [-1, 1])
over the skip-transformer denoiser (tokens: latent, time, content, emotion,
style; post-norm layers) -> the motion prior's skip-transformer decoder
over 300 zero queries cross-attending the latent -> 6D rotations ->
matrices by Gram-Schmidt (Zhou et al. 2019), and the root translation.

Parameters are the reference AMUSE state-dict keys. ``param_shapes`` lists
them, so the benchmark draws weights that both this file and the program
under test load. Nothing here imports the program.

``precision="control"`` is the same mathematics one precision step below
the configuration: every product of the AST (bf16 in the configuration) on
fp8 e4m3 operands with per-tensor scales, and every float32 product (fbank,
denoiser, decoder) in TF32. It exists to show that the benchmark's
comparison refuses a lower precision.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import fbank as fbank_ref

ENCODERS = ("con", "emo", "sty")
NUM_JOINTS = 55
JAW_JOINT = 22
FP8_MAX = 448.0
PROBE_NOISE = 2.0 ** -8  # bf16's unit roundoff


def _layer_keys(prefix: str, d: int, ff: int, cross: bool) -> dict:
    keys = {}
    for attn in ("self_attn", "multihead_attn") if cross else ("self_attn",):
        keys.update({f"{prefix}.{attn}.in_proj_weight": (3 * d, d),
                     f"{prefix}.{attn}.in_proj_bias": (3 * d,),
                     f"{prefix}.{attn}.out_proj.weight": (d, d),
                     f"{prefix}.{attn}.out_proj.bias": (d,)})
    keys.update({f"{prefix}.linear1.weight": (ff, d), f"{prefix}.linear1.bias": (ff,),
                 f"{prefix}.linear2.weight": (d, ff), f"{prefix}.linear2.bias": (d,)})
    for n in range(1, 4 if cross else 3):
        keys.update({f"{prefix}.norm{n}.weight": (d,), f"{prefix}.norm{n}.bias": (d,)})
    return keys


def _skip_keys(prefix: str, d: int, ff: int, layers: int, cross: bool) -> dict:
    half = (layers - 1) // 2
    keys = {}
    for i in range(half):
        keys.update(_layer_keys(f"{prefix}.input_blocks.{i}", d, ff, cross))
    keys.update(_layer_keys(f"{prefix}.middle_block", d, ff, cross))
    for i in range(half):
        keys.update(_layer_keys(f"{prefix}.output_blocks.{i}", d, ff, cross))
        keys.update({f"{prefix}.linear_blocks.{i}.weight": (d, 2 * d),
                     f"{prefix}.linear_blocks.{i}.bias": (d,)})
    keys.update({f"{prefix}.norm.weight": (d,), f"{prefix}.norm.bias": (d,)})
    return keys


def num_patches(ast: dict) -> int:
    f = (ast["input_fdim"] - ast["patch"]) // ast["fstride"] + 1
    t = (ast["input_tdim"] - ast["patch"]) // ast["tstride"] + 1
    return f * t


def encoder_shapes(a: dict) -> dict[str, tuple]:
    """{key: shape} of one AST encoder's trunk and feature head."""
    e = a["embed_dim"]
    enc = {"v.cls_token": (1, 1, e), "v.dist_token": (1, 1, e),
           "v.pos_embed": (1, num_patches(a) + 2, e),
           "v.patch_embed.proj.weight": (e, 1, a["patch"], a["patch"]),
           "v.patch_embed.proj.bias": (e,)}
    hidden = e * a["mlp_ratio"]
    for i in range(a["depth"]):
        p = f"v.blocks.{i}"
        enc.update({f"{p}.norm1.weight": (e,), f"{p}.norm1.bias": (e,),
                    f"{p}.attn.qkv.weight": (3 * e, e), f"{p}.attn.qkv.bias": (3 * e,),
                    f"{p}.attn.proj.weight": (e, e), f"{p}.attn.proj.bias": (e,),
                    f"{p}.norm2.weight": (e,), f"{p}.norm2.bias": (e,),
                    f"{p}.mlp.fc1.weight": (hidden, e), f"{p}.mlp.fc1.bias": (hidden,),
                    f"{p}.mlp.fc2.weight": (e, hidden), f"{p}.mlp.fc2.bias": (e,)})
    enc.update({"v.norm.weight": (e,), "v.norm.bias": (e,),
                "feature_head.0.weight": (e,), "feature_head.0.bias": (e,),
                "feature_head.1.weight": (a["feature_dim"], e),
                "feature_head.1.bias": (a["feature_dim"],)})
    return enc


def param_shapes(cfg: dict) -> dict[str, dict[str, tuple]]:
    """{"ast", "denoiser", "prior"} -> {key: shape} of the configuration."""
    enc = encoder_shapes(cfg["ast"])
    ast = {f"{name}_enc.{k}": s for name in ENCODERS for k, s in enc.items()}

    dn = cfg["denoiser"]
    d, c = dn["latent_dim"], dn["cond_dim"]
    den = {"time_embedding.linear_1.weight": (d, c), "time_embedding.linear_1.bias": (d,),
           "time_embedding.linear_2.weight": (d, d), "time_embedding.linear_2.bias": (d,)}
    for name in ENCODERS:
        den.update({f"emb_proj_{name}.1.weight": (d, c), f"emb_proj_{name}.1.bias": (d,)})
    den["query_pos.pe"] = (dn["max_len"], 1, d)
    den.update(_skip_keys("encoder", d, dn["ff_size"], dn["num_layers"], cross=False))

    pr = cfg["prior"]
    d = pr["latent_dim"]
    prior = {"skel_embedding.weight": (d, pr["nfeats"]), "skel_embedding.bias": (d,),
             "global_motion_token": (2 * pr["latent_tokens"], d),
             "query_pos_encoder.pe": (pr["max_len"], 1, d),
             "query_pos_decoder.pe": (pr["max_len"], 1, d)}
    prior.update(_skip_keys("encoder", d, pr["ff_size"], pr["num_layers"], cross=False))
    prior.update(_skip_keys("decoder", d, pr["ff_size"], pr["num_layers"], cross=True))
    prior.update({"final_layer.weight": (pr["nfeats"], d), "final_layer.bias": (pr["nfeats"],)})
    return {"ast": ast, "denoiser": den, "prior": prior}


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to fp8 e4m3 under a per-tensor scale, back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The stack of one configuration over one set of raw weights.

    ``weights``: {"ast", "denoiser", "prior"} state dicts under the keys of
    ``param_shapes``, in the types the benchmark made them (the AST in its
    served type); every tensor is taken to float32 here.
    """

    def __init__(self, cfg: dict, weights: dict, device: torch.device,
                 precision: str = "float32"):
        if precision not in ("float32", "control"):
            raise ValueError(f"precision must be float32 or control, got {precision!r}")
        self.cfg, self.device, self.control = cfg, device, precision == "control"
        self.w = {part: {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
                  for part, sd in weights.items()}

    @contextlib.contextmanager
    def _matmul_precision(self):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.control
        torch.backends.cudnn.allow_tf32 = self.control
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    # -- the AST --------------------------------------------------------------

    def _ast_mm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.control:
            x, y = _fp8(x), _fp8(y)
        return x @ y

    def _ast_linear(self, x, w, b):
        return self._ast_mm(x, w.transpose(-1, -2)) + b

    def ast_features(self, fb: torch.Tensor, name: str) -> torch.Tensor:
        """(N, 1024, 128) fbanks -> (N, feature_dim) features of one encoder."""
        a, w = self.cfg["ast"], self.w["ast"]
        p = f"{name}_enc."
        e, heads, patch = a["embed_dim"], a["num_heads"], a["patch"]
        n = fb.shape[0]
        x = fb.transpose(-1, -2).unfold(1, patch, a["fstride"]).unfold(2, patch, a["tstride"])
        x = x.reshape(n, -1, patch * patch)
        x = self._ast_linear(x, w[p + "v.patch_embed.proj.weight"].reshape(e, -1),
                             w[p + "v.patch_embed.proj.bias"])
        tokens = [w[p + "v.cls_token"].expand(n, 1, e), w[p + "v.dist_token"].expand(n, 1, e), x]
        x = torch.cat(tokens, 1) + w[p + "v.pos_embed"]
        s, hd = x.shape[1], e // heads
        for i in range(a["depth"]):
            b = f"{p}v.blocks.{i}."
            h = F.layer_norm(x, (e,), w[b + "norm1.weight"], w[b + "norm1.bias"], 1e-6)
            qkv = self._ast_linear(h, w[b + "attn.qkv.weight"], w[b + "attn.qkv.bias"])
            q, k, v = qkv.view(n, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
            att = torch.softmax(self._ast_mm(q, k.transpose(-1, -2)) / math.sqrt(hd), -1)
            o = self._ast_mm(att, v).transpose(1, 2).reshape(n, s, e)
            x = x + self._ast_linear(o, w[b + "attn.proj.weight"], w[b + "attn.proj.bias"])
            h = F.layer_norm(x, (e,), w[b + "norm2.weight"], w[b + "norm2.bias"], 1e-6)
            h = F.gelu(self._ast_linear(h, w[b + "mlp.fc1.weight"], w[b + "mlp.fc1.bias"]))
            x = x + self._ast_linear(h, w[b + "mlp.fc2.weight"], w[b + "mlp.fc2.bias"])
        x = F.layer_norm(x, (e,), w[p + "v.norm.weight"], w[p + "v.norm.bias"], 1e-6)
        pooled = x[:, 2:].mean(1)
        h = F.layer_norm(pooled, (e,), w[p + "feature_head.0.weight"],
                         w[p + "feature_head.0.bias"], 1e-5)
        return self._ast_linear(h, w[p + "feature_head.1.weight"], w[p + "feature_head.1.bias"])

    # -- the post-norm transformer layers of the denoiser and the prior -------

    @staticmethod
    def _mha(w: dict, p: str, q_in, kv_in, heads: int) -> torch.Tensor:
        d = q_in.shape[-1]
        wq, wk, wv = w[p + "in_proj_weight"].chunk(3)
        bq, bk, bv = w[p + "in_proj_bias"].chunk(3)

        def split(t):
            return t.reshape(t.shape[:-1] + (heads, d // heads)).transpose(-3, -2)

        q, k, v = split(F.linear(q_in, wq, bq)), split(F.linear(kv_in, wk, bk)), \
            split(F.linear(kv_in, wv, bv))
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d // heads), -1)
        o = (att @ v).transpose(-3, -2).reshape(q_in.shape)
        return F.linear(o, w[p + "out_proj.weight"], w[p + "out_proj.bias"])

    @staticmethod
    def _ln(w, p, x):
        return F.layer_norm(x, x.shape[-1:], w[p + "weight"], w[p + "bias"], 1e-5)

    def _layer(self, w, p, x, heads, memory=None):
        x = self._ln(w, p + "norm1.", x + self._mha(w, p + "self_attn.", x, x, heads))
        last = "norm2."
        if memory is not None:
            x = self._ln(w, p + "norm2.", x + self._mha(w, p + "multihead_attn.", x, memory,
                                                         heads))
            last = "norm3."
        ff = F.linear(F.gelu(F.linear(x, w[p + "linear1.weight"], w[p + "linear1.bias"])),
                      w[p + "linear2.weight"], w[p + "linear2.bias"])
        return self._ln(w, p + last, x + ff)

    def _skip(self, w, p, x, layers, heads, memory=None):
        half, skips = (layers - 1) // 2, []
        for i in range(half):
            x = self._layer(w, f"{p}input_blocks.{i}.", x, heads, memory)
            skips.append(x)
        x = self._layer(w, f"{p}middle_block.", x, heads, memory)
        for i in range(half):
            x = F.linear(torch.cat([x, skips.pop()], -1), w[f"{p}linear_blocks.{i}.weight"],
                         w[f"{p}linear_blocks.{i}.bias"])
            x = self._layer(w, f"{p}output_blocks.{i}.", x, heads, memory)
        return self._ln(w, p + "norm.", x)

    # -- DDIM over the denoiser -----------------------------------------------

    def _time_embedding(self, t: int, n: int) -> torch.Tensor:
        dn, w = self.cfg["denoiser"], self.w["denoiser"]
        half = dn["cond_dim"] // 2
        freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32,
                                                             device=self.device) / half)
        args = float(t) * freqs
        emb = torch.cat([torch.cos(args), torch.sin(args)])  # flip_sin_to_cos
        h = F.silu(F.linear(emb, w["time_embedding.linear_1.weight"],
                            w["time_embedding.linear_1.bias"]))
        h = F.linear(h, w["time_embedding.linear_2.weight"], w["time_embedding.linear_2.bias"])
        return h.expand(n, -1)

    def schedule(self) -> tuple[list[int], torch.Tensor]:
        """-> (timesteps in sampling order, (steps, 4) float32 coefficients
        sqrt(1/a_t), sqrt(1 - a_t), sqrt(a_prev), sqrt(1 - a_prev))."""
        df = self.cfg["diffusion"]
        total, steps = df["num_train_timesteps"], df["num_inference_steps"]
        betas = np.linspace(df["beta_start"] ** 0.5, df["beta_end"] ** 0.5, total,
                            dtype=np.float64) ** 2
        acp = torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))
        ratio = total // steps
        ts = (np.arange(steps) * ratio)[::-1] + df["steps_offset"]
        a_t = acp[torch.from_numpy(ts.copy())]
        prev = ts - ratio
        a_prev = torch.stack([acp[p] if p >= 0 else acp[0] for p in prev])
        coef = torch.stack([1.0 / torch.sqrt(a_t), torch.sqrt(1 - a_t), torch.sqrt(a_prev),
                            torch.sqrt(1 - a_prev)], 1)
        return [int(t) for t in ts], coef

    def denoise(self, x: torch.Tensor, t: int, cond: list) -> torch.Tensor:
        dn, w = self.cfg["denoiser"], self.w["denoiser"]
        n = x.shape[0]
        tokens = [x, self._time_embedding(t, n)[:, None]]
        for name, c in zip(ENCODERS, cond):
            tokens.append(F.linear(F.relu(c), w[f"emb_proj_{name}.1.weight"],
                                   w[f"emb_proj_{name}.1.bias"])[:, None])
        seq = torch.cat(tokens, 1)
        seq = seq + w["query_pos.pe"][: seq.shape[1], 0]
        out = self._skip(w, "encoder.", seq, dn["num_layers"], dn["num_heads"])
        return out[:, : dn["latent_tokens"]]

    def sample(self, cond: list, x: torch.Tensor) -> torch.Tensor:
        ts, coef = self.schedule()
        clip = self.cfg["diffusion"]["clip_sample"]
        for t, (c0, c1, c2, c3) in zip(ts, coef.tolist()):
            eps = self.denoise(x, t, cond)
            x0 = (x - c1 * eps) * c0
            if clip:
                x0 = x0.clamp(-1.0, 1.0)
            x = c2 * x0 + c3 * eps
        return x

    # -- the motion prior's decoder and the rotations -------------------------

    def decode(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, 1, D) latents -> (rotation matrices (N, T, 55, 3, 3), trans (N, T, 3))."""
        pr, w = self.cfg["prior"], self.w["prior"]
        q = w["query_pos_decoder.pe"][: pr["window"], 0].expand(z.shape[0], -1, -1)
        h = self._skip(w, "decoder.", q, pr["num_layers"], pr["num_heads"], memory=z)
        feats = F.linear(h, w["final_layer.weight"], w["final_layer.bias"])
        d6 = feats[..., :-3].reshape(feats.shape[:-1] + (NUM_JOINTS, 6))
        a1, a2 = d6[..., :3], d6[..., 3:]
        b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
        b2 = u / u.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -2), feats[..., -3:]

    # -- the whole call -------------------------------------------------------

    @torch.no_grad()
    def motion(self, chunks: torch.Tensor, x_t: torch.Tensor, zero_jaw: bool = False,
               probe_seed: Optional[int] = None, block: int = 8):
        """(N, 160000) windows and (N, 1, D) initial latents -> (matrices
        (N, T, 55, 3, 3), trans (N, T, 3)), in blocks of ``block`` windows.

        With ``probe_seed``: -> (that pair, the probe's pair), the probe being
        the same stack with its AST features given relative noise of one bf16
        unit roundoff (``PROBE_NOISE`` x N(0, 1) from a generator seeded with
        ``probe_seed``): the output's sensitivity to its conditioning."""
        gen = None if probe_seed is None else \
            torch.Generator(device=self.device).manual_seed(probe_seed)
        outs: dict = {"exact": ([], []), "probe": ([], [])}
        with self._matmul_precision():
            for i in range(0, chunks.shape[0], block):
                fb = fbank_ref.fbank(chunks[i:i + block].to(self.device))
                cond = [self.ast_features(fb, name) for name in ENCODERS]
                x = x_t[i:i + block].to(self.device, torch.float32)
                runs = [("exact", cond)]
                if gen is not None:
                    runs.append(("probe", [c * (1 + PROBE_NOISE * torch.randn(
                        c.shape, generator=gen, device=self.device)) for c in cond]))
                for key, c in runs:
                    m, tr = self.decode(self.sample(c, x))
                    outs[key][0].append(m)
                    outs[key][1].append(tr)
        pairs = []
        for key in ("exact", "probe")[: 1 if gen is None else 2]:
            mats, trans = torch.cat(outs[key][0]), torch.cat(outs[key][1])
            if zero_jaw:
                mats[..., JAW_JOINT, :, :] = torch.eye(3, device=mats.device)
            pairs.append((mats, trans))
        return pairs[0] if gen is None else tuple(pairs)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) by Rodrigues' formula, to read the
    program's poses in the reference's terms."""
    angle = aa.norm(dim=-1, keepdim=True)
    small = angle < 1e-8
    axis = aa / torch.where(small, torch.ones_like(angle), angle)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * k + (1 - c) * (k @ k)


def window_errors(mats: torch.Tensor, trans: torch.Tensor, ref_mats: torch.Tensor,
                  ref_trans: torch.Tensor) -> torch.Tensor:
    """Per window, |program - reference| / |reference| over the window's
    rotation matrices and translations together (L2) -> (N,) float32."""
    n = mats.shape[0]
    got = torch.cat([mats.reshape(n, -1), trans.reshape(n, -1)], 1).double()
    want = torch.cat([ref_mats.reshape(n, -1), ref_trans.reshape(n, -1)], 1).double()
    return ((got - want).norm(dim=1) / want.norm(dim=1)).float()


def initial_latents(shape: tuple, seed: int, device: torch.device,
                    generator_device: Optional[torch.device] = None) -> torch.Tensor:
    """x_T as the program draws it from a generator seeded with ``seed``:
    N(0, 1) of ``shape`` in float32 (DDIM's init_noise_sigma is 1)."""
    gen_dev = generator_device or device
    g = torch.Generator(device=gen_dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=gen_dev, dtype=torch.float32).to(device)
