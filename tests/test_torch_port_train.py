"""The port's stage-1 training slice (``--fn train_audio``) against the JAX package (CPU).

Tiny widths (AST 64x32 fbanks, embed 16, depth 1, 2 heads, feature 12; the
fusion and decoder blocks at their fixed widths), float32 on both sides
unless a test says otherwise, inputs from numpy seeds. JAX parameters reach
the port through ``convert.disentangler_from_jax``; the same converter
carries JAX gradient and parameter trees for the comparisons (its maps are
linear). The CUDA kernels are held against the same plain versions on the
card (tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from amuse_tpu.data import stage1 as jstage1
from amuse_tpu.eval import classification as jcls
from amuse_tpu.models import ast as jast
from amuse_tpu.models import transformer as jtr
from amuse_tpu.ops.attention import mha_fused_train
from amuse_tpu.train import audio as jta
from amuse_tpu.train import losses as jL
from amuse_tpu.train.fused_adam import make_fused_adam
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch import convert
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.data import stage1
from amuse_tpu_torch.eval import classification as cls
from amuse_tpu_torch.models import ast as tast
from amuse_tpu_torch.models import transformer as ttr
from amuse_tpu_torch.ops import attention as tatt
from amuse_tpu_torch.train import audio as ta
from amuse_tpu_torch.train import losses as L
from amuse_tpu_torch.train.checkpoint import CheckpointManager
from tests import torch_sd

AST = dict(input_tdim=64, input_fdim=32, embed_dim=16, depth=1, num_heads=2, feature_dim=12)
LR = 1e-4
CPU = torch.device("cpu")


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"fbanks": rng.normal(size=(b, 4, 64, 32)).astype(np.float32),
            "emo_id": rng.integers(0, 8, b).astype(np.int32),
            "a1_id": rng.integers(0, 30, b).astype(np.int32),
            "a2_id": rng.integers(0, 30, b).astype(np.int32)}


def _port_model(tree, **kw) -> tast.ASTDisentangler:
    """Port model loaded from a flax tree; only the untraced label head is absent."""
    model = tast.ASTDisentangler(tast.ASTConfig(**AST), **kw)
    missing, unexpected = model.load_state_dict(
        convert.disentangler_from_jax(jax.tree.map(np.asarray, tree)), strict=False)
    assert not unexpected and all(".mlp_head" in k for k in missing), missing
    return model.eval()


class TestAttentionBackward:
    """mha_train's plain path and mha_bwd_reference (K2's plain version)
    against jax.vjp through the JAX kernel pair in interpret mode."""

    @staticmethod
    def _case(shape, jdtype, tdtype):
        q, k, v, do = (_np(i, *shape) for i in range(4))
        _, vjp = jax.vjp(lambda a, b, c: mha_fused_train(a, b, c, interpret=True),
                         *(jnp.asarray(x, jdtype) for x in (q, k, v)))
        want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jdtype))]
        qkv = torch.from_numpy(np.stack([q, k, v], 2).transpose(0, 3, 2, 1, 4).copy())
        qkv = qkv.to(tdtype).requires_grad_()
        tdo = torch.from_numpy(do).to(tdtype)
        tatt.mha_train(qkv).backward(tdo)
        auto = [qkv.grad[:, :, i].transpose(1, 2) for i in range(3)]
        plain = tatt.mha_bwd_reference(*(qkv.detach()[:, :, i].transpose(1, 2)
                                         for i in range(3)), tdo)
        return want, auto, plain

    @pytest.mark.parametrize("shape", [(2, 2, 70, 16), (1, 1, 256, 32)])
    def test_float32_matches_jax(self, shape):
        """float32, ragged and two-q-block S: atol 1e-5 (tests/test_ops.py's bound)."""
        want, auto, plain = self._case(shape, jnp.float32, torch.float32)
        for w, a, p in zip(want, auto, plain):
            np.testing.assert_allclose(a.numpy(), w, atol=1e-5)
            np.testing.assert_allclose(p.numpy(), w, atol=1e-5)

    def test_bf16_matches_jax(self):
        """bfloat16: K2's plain version rounds where the TPU kernel does, so
        it agrees within one bf16 ulp (atol 1/128 at |grad| <= 1.4). Autograd
        through the plain forward rounds dP to bf16 as well: atol 2e-2."""
        want, auto, plain = self._case((1, 2, 128, 32), jnp.bfloat16, torch.bfloat16)
        for w, a, p in zip(want, auto, plain):
            assert p.dtype == torch.bfloat16
            np.testing.assert_allclose(p.float().numpy(), w, atol=1 / 128)
            np.testing.assert_allclose(a.float().numpy(), w, atol=2e-2)

    @pytest.mark.parametrize("d", [32, 64])
    @pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 257])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tile_edge_lengths_match_jax(self, dtype, s, d):
        """Sequence lengths around the 64-, 128- and 192-row tiles of the
        CUDA passes: mha_train's plain path (autograd) and mha_bwd_reference
        against jax.vjp through the JAX kernel pair in interpret mode.
        float32 atol 2e-5; bfloat16 as test_bf16_matches_jax, with the ulp
        taken at each gradient's largest entry (one bf16 ulp of it, at least
        1/128, for the plain version; 2e-2 of it for autograd, which rounds
        dP to bf16 as well)."""
        f32 = dtype == "float32"
        want, auto, plain = self._case((1, 2, s, d), jnp.float32 if f32 else jnp.bfloat16,
                                       torch.float32 if f32 else torch.bfloat16)
        for w, a, p in zip(want, auto, plain):
            assert p.shape == (1, 2, s, d) and np.isfinite(w).all()
            if f32:
                np.testing.assert_allclose(a.numpy(), w, atol=2e-5)
                np.testing.assert_allclose(p.numpy(), w, atol=2e-5)
            else:
                top = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(p.float().numpy(), w, atol=top / 128)
                np.testing.assert_allclose(a.float().numpy(), w, atol=2e-2 * top)

    def test_wrapper_layout_and_cpu_counters(self):
        """mha_bwd returns one (B, S, 3, H, D) gradient of the fused qkv;
        CPU tensors launch no kernel."""
        qkv = torch.from_numpy(_np(5, 2, 70, 3, 2, 32))
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.from_numpy(_np(6, 2, 2, 70, 32))
        before = (tatt.mha.launches, tatt.mha_bwd.launches)
        dqkv = tatt.mha_bwd(q, k, v, None, do, None)
        assert dqkv.shape == (2, 70, 3, 2, 32) and dqkv.is_contiguous()
        for i, ref in enumerate(tatt.mha_bwd_reference(q, k, v, do)):
            torch.testing.assert_close(dqkv[:, :, i].transpose(1, 2), ref, atol=0, rtol=0)
        with pytest.raises(ValueError, match="B, S, 3, H, D"):
            tatt.mha_train(q)
        assert (tatt.mha.launches, tatt.mha_bwd.launches) == before == (0, 0)


class TestDropout:
    D, H, FF = 16, 2, 32

    def _layer(self, p):
        layer = ttr.EncoderLayer(self.D, self.H, self.FF, "relu", dropout=p)
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for _, prm in layer.named_parameters():
                prm.copy_(torch.from_numpy(rng.normal(scale=0.2, size=prm.shape)
                                           .astype(np.float32)))
        return layer

    @pytest.mark.parametrize("training", [False, True])
    def test_encoder_layer_without_dropout_matches_jax(self, training):
        """Dropout 0.1 in eval mode, or 0 in training mode, is the
        deterministic JAX layer: atol 1e-5 (float32)."""
        layer = self._layer(0.0 if training else 0.1).train(training)
        p = ti.encoder_layer_from_torch(
            {f"l.{k}": v.numpy() for k, v in layer.state_dict().items()}, "l")
        x = _np(1, 2, 5, self.D)
        ref = jtr.EncoderLayer(self.D, self.H, self.FF, 0.1, "relu").apply(
            {"params": p}, x, None, True)
        mine = layer(torch.from_numpy(x), None, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), atol=1e-5)

    def test_train_mode_draws_from_the_generator(self):
        layer = self._layer(0.1).train()
        x = torch.from_numpy(_np(2, 2, 5, self.D))
        run = lambda seed: layer(x, None, torch.Generator().manual_seed(seed))  # noqa: E731
        torch.testing.assert_close(run(3), run(3), atol=0, rtol=0)
        assert not torch.allclose(run(3), run(4))
        assert not torch.allclose(run(3), layer.eval()(x))

    def test_dropout_is_inverted(self):
        x = torch.ones(200_000)
        y = ttr.dropout(x, 0.1, True, torch.Generator().manual_seed(0))
        values = y.unique().tolist()
        assert len(values) == 2 and values[0] == 0.0 and values[1] == pytest.approx(1 / 0.9)
        assert abs((y == 0).float().mean().item() - 0.1) < 5e-3
        assert ttr.dropout(x, 0.1, False) is x and ttr.dropout(x, 0.0, True) is x


def _jax_stage1_value_and_grad(dtype):
    """jitted value_and_grad of the JAX step's composition (flax model
    computing in ``dtype`` over float32 parameters), deterministic and
    unaugmented."""
    model = jast.ASTDisentangler(dtype=dtype, base_cfg=jast.ASTConfig(**AST))

    def loss(params, batch):  # amuse_tpu/train/audio.py:164-231, deterministic=True
        quad = jnp.swapaxes(batch["fbanks"], 0, 1)
        b = quad.shape[1]
        enc = model.apply({"params": params}, quad.reshape(4 * b, 64, 32), True, True,
                          method="encode")
        fe, fs, fc = (enc[k]["feature"].reshape(4, b, -1) for k in ("emo", "sty", "con"))
        part, other, ident = jnp.asarray([2, 3, 0, 1]), jnp.asarray([1, 0, 3, 2]), jnp.arange(4)
        cb = lambda e, s, c: jnp.concatenate([fe[e], fs[s], fc[c]], -1)  # noqa: E731
        groups = jnp.concatenate([cb(ident, ident, ident), cb(ident, ident, part),
                                  cb(other, ident, ident), cb(ident, other, ident)])
        recons = model.apply({"params": params}, groups, True, method="reconstruct")
        return jL.ast_swap_losses(recons, quad, enc["emo"]["logits"].reshape(4, b, -1),
                                  enc["sty"]["logits"].reshape(4, b, -1), fc,
                                  batch["emo_id"], batch["a1_id"], batch["a2_id"])

    return model, jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def jax_stage1():
    """flax-initialised stage-1 model (frame-based features) and its jitted
    value_and_grad of the step's composition, deterministic and unaugmented."""
    jcfg = jast.ASTConfig(**AST)
    params = jta.init_state(jax.random.key(0), jta.AudioTrainConfig(), jnp.float32, jcfg).params
    model, value_and_grad = _jax_stage1_value_and_grad(jnp.float32)
    return model, params, value_and_grad


class TestDisentangler:
    def test_encode_and_reconstruct_match_flax(self, jax_stage1):
        """Flax-initialised tree through disentangler_from_jax: features and
        logits atol 1e-5, fbanks atol 2e-5 (float32, summation order)."""
        jm, params, _ = jax_stage1
        model = _port_model(params)
        x = _np(3, 3, 64, 32)
        jenc = jax.jit(lambda p, x: jm.apply({"params": p}, x, True, True, method="encode"))(
            params, x)
        with torch.no_grad():
            enc = model.encode(torch.from_numpy(x), True)
        for k in ("emo", "sty", "con"):
            np.testing.assert_allclose(enc[k]["feature"].numpy(), jenc[k]["feature"], atol=1e-5)
        assert enc["con"]["logits"] is None and enc["sty"]["logits"].shape == (3, 30)
        for k in ("emo", "sty"):
            np.testing.assert_allclose(enc[k]["logits"].numpy(), jenc[k]["logits"], atol=1e-5)
        g = _np(4, 16, 2, 36)
        for method, feats in (("reconstruct", g), ("reconstruct_ablation", g[..., :24]),
                              ("reconstruct", g[0])):
            ref = jax.jit(lambda p, f: jm.apply({"params": p}, f, True, method=method))(
                params, feats)
            with torch.no_grad():
                mine = getattr(model, method)(torch.from_numpy(feats))
            assert mine.shape == ref.shape
            np.testing.assert_allclose(mine.numpy(), ref, atol=2e-5)

    def test_cls_dist_branch_and_reference_keys(self):
        """frame_based_feats=False (cls/dist pooling, the ``mlp_head`` on the
        feature): a reference-keyed state dict reaches JAX through the JAX
        package's importer, whose tree (both label heads) disentangler_from_jax
        maps back to exactly the reference keys and values; atol 1e-5."""
        sd = {}
        torch_sd.disentangler_sd(np.random.default_rng(0), sd, embed=16, depth=1,
                                 feature_dim=12, num_patches=10, out_frames=64, out_bins=32)
        tree = ti.ast_disentangler_from_torch(sd, depth=1)
        back = convert.disentangler_from_jax(tree)
        assert back.keys() == sd.keys()
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
        model = tast.ASTDisentangler(tast.ASTConfig(**AST))
        model.load_state_dict(back)
        jm = jast.ASTDisentangler(dtype=jnp.float32, base_cfg=jast.ASTConfig(**AST))
        x = _np(5, 2, 64, 32)
        jenc = jax.jit(lambda p, x: jm.apply({"params": p}, x, False, True, method="encode"))(
            tree, x)
        with torch.no_grad():
            enc = model.eval().encode(torch.from_numpy(x), False)
        for k in ("emo", "sty"):
            np.testing.assert_allclose(enc[k]["feature"].numpy(), jenc[k]["feature"], atol=1e-5)
            np.testing.assert_allclose(enc[k]["logits"].numpy(), jenc[k]["logits"], atol=1e-5)

    def test_remat_and_bf16(self, jax_stage1):
        """remat recomputes each block in the backward: same loss and
        gradients (atol 1e-6). bf16 compute over float32 parameters against
        JAX's bf16 value_and_grad of the same composition: float32
        gradients, loss rtol 2e-3 and all gradients together within 3e-2
        relative (L2). Two bf16 programs that round at slightly different
        points differ by bf16 noise, as large as the gap between bf16 and
        float32 (measured over four batches: loss 0.8-6.4e-4, gradients
        1.0-1.3e-2 against JAX bf16; JAX bf16 against float32 1.4-1.7e-2):
        the bound catches a wrong term or scale, ``TestBf16Casts`` a wrong
        cast."""
        _, params, _ = jax_stage1
        batch = _batch(7)
        tb = ta.batch_to_device(batch, CPU)
        cfg = ta.AudioTrainConfig()
        out = {}
        for name, kw in (("plain", {}), ("remat", {"remat": True})):
            model = tast.ASTDisentangler(tast.ASTConfig(**AST, **kw))
            model.load_state_dict(_port_model(params).state_dict())
            total, _ = ta.loss_fn(model.eval(), tb, cfg, augment=False)
            total.backward()
            out[name] = (total.item(), {n: p.grad for n, p in model.named_parameters()})
        assert out["plain"][0] == pytest.approx(out["remat"][0], abs=1e-6)
        for n, g in out["plain"][1].items():
            if g is not None:
                torch.testing.assert_close(out["remat"][1][n], g, atol=1e-6, rtol=0)
        _, value_and_grad = _jax_stage1_value_and_grad(jnp.bfloat16)
        (jloss, _), jgrads = value_and_grad(params, batch)
        want = convert.disentangler_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                          jgrads))
        model = tast.ASTDisentangler(tast.ASTConfig(**AST), dtype=torch.bfloat16)
        model.load_state_dict(_port_model(params).state_dict())
        total, _ = ta.loss_fn(model.eval(), tb, cfg, augment=False)
        total.backward()
        assert total.item() == pytest.approx(float(jloss), rel=2e-3)
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        assert all(g.dtype == torch.float32 for g in grads.values())
        err = sum(((g - want[n]) ** 2).sum() for n, g in grads.items()).sqrt()
        assert err <= 3e-2 * sum((want[n] ** 2).sum() for n in grads).sqrt()


class _MatmulDtypes(TorchDispatchMode):
    """Records the floating dtypes of every matmul and softmax the ops below
    it run, forward and backward."""

    OPS = {"mm", "addmm", "bmm", "baddbmm", "_softmax", "_log_softmax"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS:
            self.seen.append((name, {a.dtype for a in args if isinstance(a, torch.Tensor)
                                     and a.is_floating_point()}))
        return func(*args, **(kwargs or {}))


class TestBf16Casts:
    def test_bf16_step_runs_every_matmul_in_bf16(self, jax_stage1, monkeypatch):
        """bf16 compute over float32 parameters, as flax's ``dtype=bf16,
        param_dtype=f32``: every matmul of the step, forward and backward,
        takes bf16 operands, and every softmax float32 inputs. A parameter
        left in float32, or an activation lifted to it, puts a float32
        operand into some matmul. The attention core is a stand-in that
        rounds like K1 and K2 (bf16 products, float32 softmax); the
        kernels' own precision is held against their plain versions."""

        def attention(qkv):
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            p = torch.softmax((q @ k.transpose(-1, -2)).float() / q.shape[-1] ** 0.5, -1)
            return p.to(v.dtype) @ v

        monkeypatch.setattr(tast, "mha_train", attention)
        _, params, _ = jax_stage1
        model = tast.ASTDisentangler(tast.ASTConfig(**AST), dtype=torch.bfloat16)
        model.load_state_dict(_port_model(params).state_dict())
        tb = ta.batch_to_device(_batch(8), CPU)
        with _MatmulDtypes() as fwd:
            total, _ = ta.loss_fn(model.eval(), tb, ta.AudioTrainConfig(), augment=False)
        with _MatmulDtypes() as bwd:
            total.backward()
        for rec in (fwd, bwd):
            mm = [d for name, d in rec.seen if "softmax" not in name]
            assert mm and all(d == {torch.bfloat16} for d in mm), rec.seen
            assert all(d == {torch.float32} for name, d in rec.seen if "softmax" in name)
        # the reconstruction's whole chain: encoders, fusion, decoder, heads
        assert len([1 for name, _ in fwd.seen if name != "_softmax"]) >= 20
        assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())


class TestLosses:
    def test_swap_losses_and_stats_match_jax(self):
        rng = np.random.default_rng(0)
        b = 3
        args = [_np(1, 16, b, 8, 4), _np(2, 4, b, 8, 4), _np(3, 4, b, 8), _np(4, 4, b, 30),
                _np(5, 4, b, 12)]
        ids = [rng.integers(0, n, b).astype(np.int32) for n in (8, 30, 30)]
        _, want = jL.ast_swap_losses(*args, *ids)
        _, got = L.ast_swap_losses(*map(torch.from_numpy, args), *map(torch.from_numpy, ids))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        logits, labels = _np(6, 40, 8), rng.integers(0, 8, 40).astype(np.int32)
        logits[:20, 3] += 5.0  # some right, some wrong
        want = jcls.classification_stats(jnp.asarray(logits), jnp.asarray(labels), 8)
        got = cls.classification_stats(torch.from_numpy(logits), torch.from_numpy(labels), 8)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
        sty, sty_lab = _np(7, 40, 30), rng.integers(0, 30, 40).astype(np.int32)
        want = jcls.epoch_stats(*map(jnp.asarray, (logits, labels, sty, sty_lab)))
        got = cls.epoch_stats(*map(torch.from_numpy, (logits, labels, sty, sty_lab)))
        for group in want:
            for k in want[group]:
                assert got[group][k] == pytest.approx(want[group][k], rel=1e-6)


def _masked_params(model, tree) -> tuple[list, dict]:
    names = [n for n, p in model.named_parameters() if p.grad is not None]
    return names, convert.disentangler_from_jax(jax.tree.map(np.asarray, tree))


class TestTrainStep:
    def test_loss_and_every_gradient_match_jax(self, jax_stage1):
        """The whole slice: loss rtol 1e-6; each parameter's gradient within
        1e-4 of its largest entry (float32 through depth-1 encoders, fusion,
        decoder and 16 L1 terms; measured ~1.2e-5). Parameters the loss does
        not reach (fusion_ablation, the other label head) get no gradient
        in the port and a zero one in JAX."""
        _, params, value_and_grad = jax_stage1
        batch = _batch(1)
        (jloss, jlogs), jgrads = value_and_grad(params, batch)
        model = _port_model(params)
        total, logs = ta.loss_fn(model, ta.batch_to_device(batch, CPU),
                                 ta.AudioTrainConfig(), augment=False)
        total.backward()
        assert total.item() == pytest.approx(float(jloss), rel=1e-6)
        for k in jlogs:
            assert logs[k].item() == pytest.approx(float(jlogs[k]), rel=1e-5, abs=1e-6), k
        reached, grads = _masked_params(model, jgrads)
        assert not any(n.startswith("fusion_ablation") for n in reached)
        for n, p in model.named_parameters():
            want = grads.get(n)
            if p.grad is None:
                assert want is None or not want.abs().max() > 0, n
                continue
            err = (p.grad - want).abs().max().item()
            assert err <= 1e-4 * want.abs().max().item() + 1e-9, (n, err)

    def test_two_adam_steps_match_fused_adam(self, jax_stage1):
        """Parameters after two steps against JAX FusedAdam mode "l2" (lr
        1e-4): atol lr/10 on every element whose gradient is well above
        Adam's eps in both steps (|g| > 1e-5). Where a gradient is zero in
        exact arithmetic (the key bias of attention), each framework's
        rounding noise sets the sign of a ±lr update."""
        _, params, value_and_grad = jax_stage1
        batch = _batch(2)
        opt = make_fused_adam(b1=0.95, b2=0.999, weight_decay=5e-7, mode="l2")
        apply = jax.jit(opt.apply)
        jstate, jparams, jgrads = opt.init(params, LR), params, []
        for _ in range(2):
            _, g = value_and_grad(jparams, batch)
            jgrads.append(convert.disentangler_from_jax(jax.tree.map(np.asarray, g)))
            jparams, jstate = apply(jstate, jparams, g)
        model = _port_model(params)
        cfg = ta.AudioTrainConfig(learning_rate=LR)
        state = ta.AudioTrainState(model, ta.make_optimizer(model, cfg))
        step, _ = ta.make_train_step(cfg)
        tb = ta.batch_to_device(batch, CPU)
        for _ in range(2):
            logs = step(state, tb, None, stochastic=False)
        assert state.step == 2 and torch.isfinite(logs["total"])
        reached, want = _masked_params(model, jparams)
        moved = 0
        for n, p in model.named_parameters():
            if n not in reached:
                continue
            keep = (jgrads[0][n].abs() > 1e-5) & (jgrads[1][n].abs() > 1e-5)
            diff = (p.detach() - want[n]).abs()[keep]
            assert diff.numel() == 0 or diff.max().item() <= LR / 10, n
            moved += int(keep.sum())
        assert moved > 0.75 * sum(p.numel() for n, p in model.named_parameters() if n in reached)

    def test_unreached_parameters_follow_fused_adam(self, jax_stage1):
        """fusion_ablation.* gets no gradient from the loss. JAX's FusedAdam
        mode "l2" adds wd * p to its zero gradient, so it moves by about lr a
        step (2.94e-4 after three); the port's zero-filled gradient does the
        same through torch's L2 weight_decay: every element within lr/10 of
        JAX after three steps, no mask. Each parameter with a JAX counterpart
        has taken three Adam steps; the untraced label head has taken none."""
        _, params, value_and_grad = jax_stage1
        batch = _batch(3)
        opt = make_fused_adam(b1=0.95, b2=0.999, weight_decay=5e-7, mode="l2")
        apply = jax.jit(opt.apply)
        jstate, jparams = opt.init(params, LR), params
        for _ in range(3):
            _, g = value_and_grad(jparams, batch)
            jparams, jstate = apply(jstate, jparams, g)
        model = _port_model(params)
        cfg = ta.AudioTrainConfig(learning_rate=LR)
        state = ta.AudioTrainState(model, ta.make_optimizer(model, cfg))
        step, _ = ta.make_train_step(cfg)
        tb = ta.batch_to_device(batch, CPU)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        for _ in range(3):
            step(state, tb, None, stochastic=False)
        want = convert.disentangler_from_jax(jax.tree.map(np.asarray, jparams))
        ablation = [n for n, _ in model.named_parameters() if n.startswith("fusion_ablation.")]
        assert ablation
        for n, p in model.named_parameters():
            steps = state.optimizer.state.get(p, {}).get("step")
            if n in want:
                assert steps is not None and int(steps) == 3, n
            else:
                assert ".mlp_head." in n and steps is None, n
                assert torch.equal(p.detach(), start[n]), n
        moved = max((want[n] - start[n]).abs().max().item() for n in ablation)
        assert moved > 2 * LR, moved  # JAX moved them (zero biases stay): the check has teeth
        params_now = dict(model.named_parameters())
        for n in ablation:
            assert (params_now[n].detach() - want[n]).abs().max().item() <= LR / 10, n

    def test_lr_schedule_and_set_lr(self):
        cfg = ta.AudioTrainConfig(learning_rate=1e-5, lr_decay_start_epoch=5, lr_decay_gamma=0.85)
        jcfg = jta.AudioTrainConfig(learning_rate=1e-5, lr_decay_start_epoch=5,
                                    lr_decay_gamma=0.85)
        for epoch in (0, 4, 5, 7, 20):
            assert ta.lr_schedule(cfg, epoch) == jta.lr_schedule(jcfg, epoch)
        model = torch.nn.Linear(2, 2)
        state = ta.AudioTrainState(model, ta.make_optimizer(model, cfg))
        _, set_lr = ta.make_train_step(cfg)
        set_lr(state, 10)
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5 * 0.85**6)
        assert state.optimizer.param_groups[0]["betas"] == (0.95, 0.999)

    def test_remat_switch_follows_the_cards_memory(self, monkeypatch):
        """remat only where a step without it would take over 90% of the
        card's memory: never on the CPU; at the flagship widths on an 80 GB
        card not at the reference batches of 1-3 quads, and from some batch
        on. The estimate is linear in the quads; float32 doubles the
        activations."""
        flagship = tast.ASTConfig()
        assert not ta.remat_needed(flagship, 1000, torch.bfloat16, CPU)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: types.SimpleNamespace(total_memory=80 * 10**9))
        need = [ta.remat_needed(flagship, q, torch.bfloat16, torch.device("cuda"))
                for q in range(1, 33)]
        assert need[:3] == [False] * 3 and need[-1] and need == sorted(need)
        est = [ta.step_peak_bytes(flagship, q, torch.bfloat16) for q in (1, 2, 3)]
        assert est[2] - est[1] == pytest.approx(est[1] - est[0]) and est[1] > est[0]
        f32 = [ta.step_peak_bytes(flagship, q, torch.float32) for q in (1, 2)]
        assert f32[1] - f32[0] == pytest.approx(2 * (est[1] - est[0]))

    def test_stochastic_step_is_reproducible(self, jax_stage1):
        """Augmentation and dropout draw from the step's generator only: the
        same (seed, epoch, step) replays the same loss; another step differs."""
        _, params, _ = jax_stage1
        tb = ta.batch_to_device(_batch(3), CPU)
        cfg = ta.AudioTrainConfig(freq_mask=4, time_mask=8)
        losses = []
        for step_idx in (0, 0, 1):
            model = _port_model(params).train()
            gen = ta.step_generator(7, 1, step_idx, CPU)
            losses.append(ta.loss_fn(model, tb, cfg, gen)[0].item())
        assert losses[0] == losses[1] != losses[2]


class TestSpecAugment:
    """Properties of the port's vectorised spec_augment, mirroring
    tests/test_audio_train.py's for the JAX one."""

    def test_masks_zero_regions_and_target_is_noise_free(self):
        fb = torch.ones((4, 64, 32))
        target, out = ta.spec_augment(torch.Generator().manual_seed(0), fb, 8, 16, noise=False)
        assert out.shape == fb.shape and torch.equal(target, out)
        assert (out == 0).any()
        target, noisy = ta.spec_augment(torch.Generator().manual_seed(1), torch.zeros(3, 64, 32),
                                        0, 0, noise=True)
        assert noisy.abs().sum() > 0 and torch.equal(target, torch.zeros(3, 64, 32))
        assert noisy.max() < 0.1

    def test_start_independent_of_width_and_final_column_reachable(self):
        """Widths uniform on {0..mask-1} (mean ~7.5 for 16), every width
        reachable, and the mask reaches the last frequency column."""
        _, out = ta.spec_augment(torch.Generator().manual_seed(2), torch.ones(600, 64, 32),
                                 16, 0, noise=False)
        cols = out[:, 0] == 0  # (600, 32) frequency mask per member
        widths = cols.sum(1)
        assert 6.0 < widths.float().mean() < 9.0
        assert widths.min() == 0 and widths.max() == 15
        assert cols[:, -1].any()
        starts = cols.float().argmax(1)[widths > 0]
        # start uniform on [0, F - w]: wide masks start early, narrow ones anywhere
        assert starts[widths[widths > 0] <= 2].max() >= 28

    def test_roll_and_determinism(self):
        fb = torch.from_numpy(_np(3, 5, 64, 32))
        a = ta.spec_augment(torch.Generator().manual_seed(3), fb, 8, 16, True)
        b = ta.spec_augment(torch.Generator().manual_seed(3), fb, 8, 16, True)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=0, rtol=0)
        ramp = torch.arange(64.0)[None, :, None].expand(5, 64, 32).contiguous()
        _, rolled = ta.spec_augment(torch.Generator().manual_seed(4), ramp, 0, 0, True)
        # each member is its ramp rolled by one shift in [-10, 10), plus noise < 0.1
        shift = (rolled[:, 0, 0].round().long() * -1) % 64
        shift = torch.where(shift >= 32, shift - 64, shift)
        assert ((shift >= -10) & (shift < 10)).all()
        for i in range(5):
            want = torch.roll(ramp[i], int(shift[i]), dims=0)
            assert (rolled[i] - want).abs().max() < 0.1


class TestStage1Data:
    def _splits(self, seed):
        rng = np.random.default_rng(seed)

        def split(n, m):
            return {"fbank_bank": rng.normal(size=(m, 64, 32)).astype(np.float32),
                    "quad_idx": rng.integers(0, m, (n, 4)).astype(np.int32),
                    "emo_id": rng.integers(0, 8, n).astype(np.int32),
                    "a1_id": rng.integers(0, 30, n).astype(np.int32),
                    "a2_id": rng.integers(0, 30, n).astype(np.int32)}

        return split(7, 9), split(3, 5)

    def test_reads_and_writes_the_jax_npz(self, tmp_path):
        train, val = self._splits(0)
        jstage1.save_dataset(tmp_path / "j.npz", train, val, ["1/a", "2/b"])
        stage1.save_dataset(tmp_path / "t", train, val, ["1/a", "2/b"])
        assert (tmp_path / "t.npz").exists()
        for name in ("j.npz", "t"):
            for loader in (stage1.load_dataset, jstage1.load_dataset):
                got = loader(tmp_path / name)
                for split, ref in zip(got, (train, val)):
                    assert split.keys() == ref.keys()
                    for k in ref:
                        np.testing.assert_array_equal(split[k], ref[k])
            assert stage1.dataset_is_current(tmp_path / name, ["1/a", "2/b"])
            assert not stage1.dataset_is_current(tmp_path / name, ["1/a"])
        assert not stage1.dataset_is_current(tmp_path / "missing.npz", [])
        t_train, _ = stage1.load_dataset(tmp_path / "j.npz")
        for bsz in (2, 3):
            got = list(stage1.batches(t_train, bsz, np.random.default_rng([1, 2])))
            want = list(jstage1.batches(train, bsz, np.random.default_rng([1, 2])))
            assert len(got) == len(want) == 7 // bsz
            for g, w in zip(got, want):
                assert g["fbanks"].shape == (bsz, 4, 64, 32)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


TINY = {"audio": {"ast_embed_dim": 16, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12,
                  "target_length": 64, "num_mel_bins": 32, "freq_mask": 4, "time_mask": 8,
                  "epochs": 2, "batch_size": 2},
        "dtype": "float32"}


class TestCli:
    def _tree(self, tmp_path):
        train, val = TestStage1Data()._splits(1)
        stage1.save_dataset(tmp_path / "stage1.npz", train, val, ["1/a"])
        cfg = dict(TINY, out_dir=str(tmp_path / "runs"),
                   data={"stage1_dataset": str(tmp_path / "stage1.npz")})
        (tmp_path / "tiny.json").write_text(json.dumps(cfg))
        return str(tmp_path / "tiny.json")

    def test_train_audio_cpu_checkpoint_and_resume(self, tmp_path, capsys):
        cfg = self._tree(tmp_path)
        cli.main(["--fn", "train_audio", "--cfg", cfg, "--device", "cpu"])
        (run,) = (tmp_path / "runs").iterdir()
        records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in records] == [0, 1]
        assert all(np.isfinite(r["train_total"]) and "val_emo_acc" in r for r in records)
        mgr = CheckpointManager(run / "checkpoints")
        assert mgr.steps() == [1, 2]
        assert mgr.metadata(2)["metrics"]["train_total"] == pytest.approx(records[1]["train_total"])
        state, meta = mgr.restore()
        assert state["step"] == 6 and meta["step"] == 2  # 3 steps of 2 quads per epoch
        assert mgr.best_step("train_total") in (1, 2)
        capsys.readouterr()
        cli.main(["--fn", "train_audio", "--cfg", cfg, "--device", "cpu",
                  "--set", f"resume={run / 'checkpoints'}", "--set", "audio.epochs=3"])
        out = capsys.readouterr().out
        assert "resumed full train state" in out and "at epoch 2" in out
        assert "epoch 3/3" in out and "epoch 1/3" not in out

    def test_refusals(self, tmp_path):
        cfg = self._tree(tmp_path)
        (tmp_path / "ckpt" / "step_00000001" / "state").mkdir(parents=True)
        with pytest.raises(NotImplementedError, match="orbax"):
            CheckpointManager(tmp_path / "ckpt").restore()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                cli.main(["--fn", "train_audio", "--cfg", cfg])
