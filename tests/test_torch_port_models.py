"""The PyTorch port's models against the JAX package at small widths (CPU, float32).

Weights travel both ways: port modules get numpy-seeded random weights and
reach JAX through the JAX package's own importer (``utils/torch_import``,
reference key names); flax-initialised JAX params reach the port through
``amuse_tpu_torch.convert``. Inputs are made with numpy from a seed.
Tolerances: float32 on both sides, differing only in summation order, so
1e-5 for single layers and 1e-4 for deep stacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from amuse_tpu.models import ast as jast
from amuse_tpu.models import denoiser as jden
from amuse_tpu.models import transformer as jtr
from amuse_tpu.models import vae as jvae
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch import convert
from amuse_tpu_torch.models import ast as tast
from amuse_tpu_torch.models import denoiser as tden
from amuse_tpu_torch.models import transformer as ttr
from amuse_tpu_torch.models import vae as tvae


def _randomize(module: nn.Module, seed: int) -> nn.Module:
    """Every parameter from a seeded normal (LayerNorm weights around 1)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            vals = rng.normal(scale=0.2, size=tuple(p.shape)).astype(np.float32)
            if "norm" in name and name.endswith("weight"):
                vals += 1.0
            p.copy_(torch.from_numpy(vals))
    return module.eval()


def _sd(module: nn.Module, prefix: str) -> dict:
    return {f"{prefix}.{k}": v.numpy() for k, v in module.state_dict().items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(mine: torch.Tensor, ref, atol):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


D, H, FF = 16, 2, 32


class TestTransformer:
    def test_attention_with_padding_mask(self):
        port = _randomize(ttr.MultiHeadAttention(D, H), 0)
        p = ti._mha(_sd(port, "a"), "a")
        q, kv = _x(1, 2, 5, D), _x(2, 2, 7, D)
        mask = np.arange(7)[None, :] < np.array([[7], [4]])
        ref = jtr.MultiHeadAttention(D, H).apply({"params": p}, q, kv, kv, jnp.asarray(mask))
        mine = port(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                    torch.from_numpy(mask))
        _close(mine, ref, 1e-5)

    def test_feed_forward(self):
        l1, l2 = _randomize(nn.Linear(D, FF), 3), _randomize(nn.Linear(FF, D), 4)
        x = _x(5, 2, 3, D)
        p = {"linear1": ti._linear(_sd(l1, "l"), "l"), "linear2": ti._linear(_sd(l2, "l"), "l")}
        ref = jtr.FeedForward(D, FF).apply({"params": p}, x)
        _close(ttr.feed_forward(torch.from_numpy(x), l1, l2), ref, 1e-5)

    @pytest.mark.parametrize("normalize_before", [False, True])
    def test_encoder_layer(self, normalize_before):
        port = _randomize(ttr.EncoderLayer(D, H, FF, normalize_before=normalize_before), 6)
        p = ti.encoder_layer_from_torch(_sd(port, "l"), "l")
        x = _x(7, 2, 6, D)
        mask = np.arange(6)[None, :] < np.array([[6], [3]])
        ref = jtr.EncoderLayer(D, H, FF, normalize_before=normalize_before).apply(
            {"params": p}, x, jnp.asarray(mask))
        _close(port(torch.from_numpy(x), torch.from_numpy(mask)), ref, 1e-5)

    @pytest.mark.parametrize("normalize_before", [False, True])
    def test_decoder_layer(self, normalize_before):
        port = _randomize(ttr.DecoderLayer(D, H, FF, normalize_before=normalize_before), 8)
        p = ti.decoder_layer_from_torch(_sd(port, "l"), "l")
        tgt, mem = _x(9, 2, 6, D), _x(10, 2, 1, D)
        ref = jtr.DecoderLayer(D, H, FF, normalize_before=normalize_before).apply(
            {"params": p}, tgt, mem)
        _close(port(torch.from_numpy(tgt), torch.from_numpy(mem)), ref, 1e-5)

    def test_skip_stacks(self):
        enc = _randomize(ttr.SkipEncoder(D, H, FF, 5), 11)
        x = _x(12, 2, 6, D)
        ref = jtr.SkipEncoder(D, H, FF, 5).apply(
            {"params": ti.skip_encoder_from_torch(_sd(enc, "e"), "e", 5)}, x)
        _close(enc(torch.from_numpy(x)), ref, 1e-4)
        dec = _randomize(ttr.SkipDecoder(D, H, FF, 5), 13)
        mem = _x(14, 2, 1, D)
        ref = jtr.SkipDecoder(D, H, FF, 5).apply(
            {"params": ti.skip_decoder_from_torch(_sd(dec, "d"), "d", 5)}, x, mem)
        _close(dec(torch.from_numpy(x), torch.from_numpy(mem)), ref, 1e-4)
        with pytest.raises(ValueError):
            ttr.SkipEncoder(D, H, FF, 4)

    def test_positions_and_lengths(self):
        pos = ttr.LearnedPositionalEmbedding(D, 20)
        x = _x(15, 2, 6, D)
        ref = jtr.LearnedPositionalEmbedding(D, 20).apply(
            {"params": {"pe": pos.pe.detach().numpy()[:, 0]}}, x)
        _close(pos(torch.from_numpy(x)), ref, 1e-6)
        lengths = np.array([3, 6])
        np.testing.assert_array_equal(
            ttr.lengths_to_mask(torch.from_numpy(lengths), 6).numpy(),
            np.asarray(jtr.lengths_to_mask(jnp.asarray(lengths), 2, 6)))
        assert ttr.lengths_to_mask(None, 6) is None


def _jax_denoiser(cfg_kw, seed=0):
    jcfg = jden.DenoiserConfig(**cfg_kw)
    params = jden.init_denoiser_params(jax.random.key(seed), jcfg)
    port = tden.Denoiser(tden.DenoiserConfig(**cfg_kw)).eval()
    port.load_state_dict(convert.denoiser_from_jax(params))
    return jcfg, params, port


class TestDenoiser:
    KW = dict(latent_dim=D, ff_size=FF, num_layers=3, num_heads=H, cond_dim=12)

    def test_timestep_embedding(self):
        ts = np.array([1, 21, 981, 500])
        for dim in (12, 13):
            ref = jden.timestep_embedding(jnp.asarray(ts), dim)
            _close(tden.timestep_embedding(torch.from_numpy(ts), dim), ref, 1e-5)

    @pytest.mark.parametrize("streams", ["all", "con_only", "no_emo"])
    def test_matches_jax(self, streams):
        jcfg, params, port = _jax_denoiser(self.KW)
        b = 3
        x, con, emo, sty = _x(1, b, 1, D), _x(2, b, 12), _x(3, b, 12), _x(4, b, 12)
        emo = None if streams in ("con_only", "no_emo") else emo
        sty = None if streams == "con_only" else sty
        ts = np.array([981, 21, 1])
        ref = jden.Denoiser(jcfg).apply({"params": params}, x, jnp.asarray(ts), con, emo, sty)
        opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        mine = port(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(con),
                    opt(emo), opt(sty))
        _close(mine, ref, 1e-4)
        scalar = port(torch.from_numpy(x), 21, torch.from_numpy(con), opt(emo), opt(sty))
        ref_s = jden.Denoiser(jcfg).apply({"params": params}, x, jnp.asarray(21), con, emo, sty)
        _close(scalar, ref_s, 1e-4)


class TestMotionPrior:
    KW = dict(nfeats=21, latent_dim=D, ff_size=FF, num_layers=3, num_heads=H, window=12)

    def _models(self):
        jcfg = jvae.PriorConfig(**self.KW)
        params = jvae.init_prior_params(jax.random.key(1), jcfg)
        port = tvae.MotionPrior(tvae.PriorConfig(**self.KW)).eval()
        port.load_state_dict(convert.prior_from_jax(params))
        return jvae.MotionPrior(jcfg), params, port

    def test_encode_decode_match_jax(self):
        jm, params, port = self._models()
        feats = _x(5, 2, 12, 21)
        lengths = np.array([12, 7])
        for lens in (None, lengths):
            tl = None if lens is None else torch.from_numpy(lens)
            jl = None if lens is None else jnp.asarray(lens)
            mu, logvar = port.encode_params(torch.from_numpy(feats), tl)
            jmu, jlogvar = jm.apply({"params": params}, feats, jl, method="encode_params")
            _close(mu, jmu, 1e-4)
            _close(logvar, jlogvar, 1e-4)
            z = _x(6, 2, 1, D)
            ref = jm.apply({"params": params}, z, 12, jl, method="decode")
            _close(port.decode(torch.from_numpy(z), 12, tl), ref, 1e-4)
        noise = _x(7, 2, 1, D)
        # jmu/jlogvar are the masked run's (the loop's last)
        z, _ = port.encode(torch.from_numpy(feats), lengths=torch.from_numpy(lengths),
                           noise=torch.from_numpy(noise))
        _close(z, np.asarray(jmu) + np.exp(0.5 * np.asarray(jlogvar)) * noise, 1e-4)
        z2, _ = port.encode(torch.from_numpy(feats), torch.Generator().manual_seed(0))
        assert z2.shape == (2, 1, D) and torch.isfinite(z2).all()

    def test_kl(self):
        mu, logvar = _x(8, 4, 1, D), 0.3 * _x(9, 4, 1, D)
        ref = jvae.kl_divergence_normal(jnp.asarray(mu), jnp.asarray(logvar))
        _close(tvae.kl_divergence_normal(torch.from_numpy(mu), torch.from_numpy(logvar)),
               ref, 1e-6)


class TestAST:
    CFG = dict(embed_dim=D, depth=2, num_heads=H, feature_dim=12)

    def test_extract_patches_equals_strided_conv(self):
        cfg = tast.ASTConfig(**self.CFG)
        spec = _x(1, 2, 1024, 128)
        conv = _randomize(nn.Conv2d(1, D, 16, stride=(10, 10)), 2)
        with torch.no_grad():
            ref = conv(torch.from_numpy(spec).transpose(1, 2)[:, None])  # (B, E, 12, 101)
            ref = ref.flatten(2).transpose(1, 2)
            patches = tast.extract_patches(torch.from_numpy(spec), cfg)
            mine = patches @ conv.weight.reshape(D, -1).T + conv.bias
        assert patches.shape == (2, 1212, 256)
        _close(mine, ref, 1e-5)
        jcfg = jast.ASTConfig(**self.CFG)
        _close(patches, jast.extract_patches(jnp.asarray(spec), jcfg), 0)

    def test_vit_block(self):
        cfg = tast.ASTConfig(**self.CFG)
        block = _randomize(tast.ViTBlock(cfg), 3)
        x = _x(4, 2, 9, D)
        p = ti._vit_block_from_torch(_sd(block, "b"), "b")
        ref = jast.ViTBlock(jast.ASTConfig(**self.CFG)).apply({"params": p}, x)
        _close(block(torch.from_numpy(x)), ref, 1e-5)

    @pytest.mark.parametrize("frame_based_feats", [True, False])
    def test_encoder_port_to_jax(self, frame_based_feats):
        port = _randomize(tast.ASTEncoder(tast.ASTConfig(**self.CFG)), 5)
        p = ti.ast_encoder_from_torch(_sd(port, "enc"), "enc", depth=2)
        spec = _x(6, 2, 1024, 128)
        ref = jast.ASTEncoder(jast.ASTConfig(**self.CFG)).apply(
            {"params": p}, spec, frame_based_feats)["feature"]
        out = port(torch.from_numpy(spec), frame_based_feats)
        assert out["logits"] is None
        _close(out["feature"], ref, 1e-4)

    def test_encoder_jax_to_port_and_stacking(self):
        jcfg = jast.ASTConfig(**self.CFG)
        spec = _x(7, 3, 1024, 128)
        encs, refs = [], []
        for seed in range(2):
            params = jast.ASTEncoder(jcfg).init(jax.random.key(seed), spec[:1])["params"]
            refs.append(np.asarray(jast.ASTEncoder(jcfg).apply({"params": params}, spec)["feature"]))
            enc = tast.ASTEncoder(tast.ASTConfig(**self.CFG)).eval()
            enc.load_state_dict(convert.ast_encoder_from_jax(params))
            encs.append(enc)
        params = [dict(e.named_parameters()) for e in encs]
        stacked = {n: torch.stack([p[n].detach() for p in params]) for n in params[0]}
        feats = tast.ast_features(stacked, torch.from_numpy(spec), tast.ASTConfig(**self.CFG))
        assert feats.shape == (2, 3, 12)
        for g in range(2):
            _close(feats[g], refs[g], 1e-4)
