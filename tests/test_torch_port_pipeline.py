"""The PyTorch port's inference pipeline and CLI against the JAX package (CPU).

Tiny-but-real configs: the full 1024x128 fbank input, narrow shallow stacks
(the widths of the tiny CLI drive config). The JAX pipeline's parameters are
carried to the port with ``from_jax_params``, and both sides sample from the
same initial latents.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amuse_tpu.infer.pipeline import GesturePipeline as JPipeline
from amuse_tpu.infer.pipeline import PipelineParams as JParams
from amuse_tpu.models.ast import ASTConfig as JAST
from amuse_tpu.models.denoiser import DenoiserConfig as JDen
from amuse_tpu.models.denoiser import init_denoiser_params
from amuse_tpu.models.vae import PriorConfig as JPrior
from amuse_tpu.models.vae import init_prior_params
from amuse_tpu.utils import torch_import as ti
from amuse_tpu_torch.audio.wavio import save_wav
from amuse_tpu_torch.cli import main as cli
from amuse_tpu_torch.convert import from_jax_params
from amuse_tpu_torch.core.rotations import axis_angle_to_matrix
from amuse_tpu_torch.infer.pipeline import GesturePipeline, PipelineParams, init_random_params
from amuse_tpu_torch.models.ast import ASTConfig
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from amuse_tpu_torch.ops import attention, denoiser_kernel
from tests import torch_sd

AST_KW = dict(embed_dim=16, depth=1, num_heads=2, feature_dim=12)
DEN_KW = dict(latent_dim=16, ff_size=32, num_layers=3, num_heads=2, cond_dim=12)
PRIOR_KW = dict(latent_dim=16, ff_size=32, num_layers=3, num_heads=2)
STEPS = 3


def _port(params, dtype=torch.float32):
    return GesturePipeline(params, PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW),
                           ASTConfig(**AST_KW), dtype=dtype, num_inference_steps=STEPS,
                           device="cpu")


def _jax(params, dtype=jnp.float32):
    return JPipeline(params, JPrior(**PRIOR_KW), JDen(**DEN_KW), JAST(**AST_KW), dtype=dtype,
                     num_inference_steps=STEPS)


def _jax_params(seed):
    """JAX pipeline params: flax-initialised prior and denoiser; the AST tree
    from a small reference state dict (flax-initialising the stage-1 model
    would also build its 134M-parameter fbank decoder)."""
    sd = {}
    torch_sd.disentangler_sd(np.random.default_rng(seed), sd, embed=16, depth=1,
                             feature_dim=12, fusion_dim=8, out_frames=4, out_bins=4)
    k1, k2 = jax.random.split(jax.random.key(seed))
    return JParams(ast=ti.ast_disentangler_from_torch(sd, depth=1),
                   prior=init_prior_params(k1, JPrior(**PRIOR_KW)),
                   denoiser=init_denoiser_params(k2, JDen(**DEN_KW)))


@pytest.fixture(scope="module")
def pipes():
    jparams = _jax_params(0)
    tree = jax.tree.map(np.asarray, jparams._asdict())
    return _jax(jparams), _port(from_jax_params(tree)), jparams, tree


def _chunks(seed, n=2):
    return np.random.default_rng(seed).normal(scale=0.05, size=(n, 160000)).astype(np.float32)


def _latents(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, 1, 16)).astype(np.float32)


def _compare(jpipe, pipe, chunks, x0, feat_atol, pose_atol):
    """Stage by stage: features, latents, then poses and translation."""
    jc = jpipe.encode_audio(jnp.asarray(chunks))
    tc = pipe.encode_audio(chunks)
    for k in ("con", "emo", "sty"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=feat_atol, rtol=1e-3)
    jl = jpipe.generate_latents(None, jc["con"], jc["emo"], jc["sty"],
                                initial_latents=jnp.asarray(x0))
    poses, trans = pipe.wav_to_motion(chunks, initial_latents=torch.from_numpy(x0))
    jposes, jtrans = jpipe.decode_motion(jl)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), atol=pose_atol, rtol=1e-3)
    # compare rotations, not axis-angle: equivalent near angle pi
    np.testing.assert_allclose(axis_angle_to_matrix(poses).numpy(),
                               np.asarray(axis_angle_to_matrix(torch.from_numpy(
                                   np.array(jposes)))), atol=pose_atol)
    return poses, trans


class TestPipelineVsJax:
    def test_wav_to_motion_float32(self, pipes):
        """float32 end to end: features atol 1e-4, poses/trans atol 1e-3 (three
        stacks and a 3-step DDIM loop of float32 rounding in two frameworks)."""
        jpipe, pipe, _, _ = pipes
        poses, trans = _compare(jpipe, pipe, _chunks(0), _latents(1), 1e-4, 1e-3)
        assert poses.shape == (2, 300, 55, 3) and trans.shape == (2, 300, 3)
        assert attention.mha.launches == 0 and denoiser_kernel.ddim_sample_fused.launches == 0

    def test_wav_to_motion_bf16_ast(self):
        """AST in bfloat16 on both sides (the pipeline default): the bf16
        matmul and LayerNorm roundings differ between XLA and torch, so the
        256-d features are compared at atol 5e-2 and the outputs for shape
        and finiteness."""
        jparams = _jax_params(1)
        jpipe = _jax(jparams, jnp.bfloat16)
        pipe = _port(from_jax_params(jax.tree.map(np.asarray, jparams._asdict())), torch.bfloat16)
        chunks = _chunks(2, 1)
        jc = jpipe.encode_audio(jnp.asarray(chunks))
        tc = pipe.encode_audio(chunks)
        for k in ("con", "emo", "sty"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k], np.float32), atol=5e-2)
        poses, trans = pipe.wav_to_motion(chunks, generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(poses).all() and torch.isfinite(trans).all()

    def test_both_ast_layouts_convert(self, pipes):
        _, _, jparams, tree = pipes
        stacked = dict(tree)
        stacked["ast"] = {"con": tree["ast"]["con_enc"], "emo": tree["ast"]["emo_enc"],
                          "sty": tree["ast"]["sty_enc"]}
        a, b = from_jax_params(tree), from_jax_params(stacked)
        assert a.ast.keys() == b.ast.keys()
        for k in a.ast:
            torch.testing.assert_close(a.ast[k], b.ast[k], atol=0, rtol=0)

    def test_infer_wav_determinism_and_export_fields(self, pipes):
        _, pipe, _, _ = pipes
        wave = np.random.default_rng(3).normal(scale=0.05, size=340000).astype(np.float32)
        a, b = pipe.infer_wav(wave, seed=5), pipe.infer_wav(wave, seed=5)
        assert a["poses"].shape == (2, 300, 55, 3)
        np.testing.assert_array_equal(a["poses"], b["poses"])
        assert np.abs(a["poses"][:, :, 22]).sum() == 0.0  # jaw zeroed for export
        mu = pipe.encode_motion_mu(pipe.motion_feats(torch.zeros(1, 300, 168)))
        z = pipe.encode_motion(pipe.motion_feats(torch.zeros(1, 300, 168)),
                               torch.Generator().manual_seed(0))
        assert mu.shape == z.shape == (1, 1, 16)


def test_reference_state_dict_loads_into_both():
    """One reference-keyed state dict (tests/torch_sd.py) loads into the port
    directly and into JAX through torch_import; the outputs agree (float32,
    features atol 1e-4, poses/trans atol 1e-3)."""
    rng = np.random.default_rng(0)
    sd_ast, sd_prior, sd_den = {}, {}, {}
    torch_sd.disentangler_sd(rng, sd_ast, embed=16, depth=1, feature_dim=12, fusion_dim=8,
                             out_frames=4, out_bins=4)
    torch_sd.prior_sd(rng, sd_prior, d=16, ff=32, layers=3)
    torch_sd.denoiser_sd(rng, sd_den, d=16, ff=32, layers=3, cond=12)
    port = _port(PipelineParams(ast=sd_ast, prior=sd_prior, denoiser=sd_den))
    jpipe = _jax(JParams(
        ast=ti.ast_disentangler_from_torch(sd_ast, depth=1),
        prior=ti.motion_prior_from_torch(sd_prior, num_layers=3),
        denoiser=ti.denoiser_from_torch(sd_den, num_layers=3),
    ))
    _compare(jpipe, port, _chunks(4, 1), _latents(5, 1), 1e-4, 1e-3)


def test_default_device_raises_without_cuda():
    params = init_random_params(0, PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW),
                                ASTConfig(**AST_KW))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        GesturePipeline(params, PriorConfig(**PRIOR_KW), DenoiserConfig(**DEN_KW),
                        ASTConfig(**AST_KW))


TINY = {
    "audio": {"ast_embed_dim": 16, "ast_depth": 1, "ast_heads": 2, "ast_feature_dim": 12},
    "gesture": {"latent_dim": 16, "ff_size": 32, "num_layers": 3, "num_heads": 2,
                "cond_dim": 12, "num_inference_steps": 3},
    "dtype": "float32",
}


class TestCli:
    def _tree(self, tmp_path):
        wavs = tmp_path / "wavs"
        wavs.mkdir()
        rng = np.random.default_rng(6)
        save_wav(wavs / "2_scott_0_9_9.wav", rng.normal(scale=0.05, size=320000).astype(np.float32))
        save_wav(wavs / "short.wav", np.zeros(1000, np.float32))
        cfg = dict(TINY, out_dir=str(tmp_path / "runs"))
        (tmp_path / "tiny.json").write_text(json.dumps(cfg))
        return wavs, tmp_path / "tiny.json"

    def test_infer_gesture_cpu(self, tmp_path, monkeypatch, capsys):
        monkeypatch.delenv("AMUSE_TPU_CKPT", raising=False)
        wavs, cfg = self._tree(tmp_path)
        cli.main(["--fn", "infer_gesture", "--cfg", str(cfg), "--wav-dir", str(wavs),
                  "--device", "cpu"])
        out = capsys.readouterr().out
        assert "random weights" in out and "short.wav: shorter" in out
        seqs = sorted((tmp_path / "runs").glob("*/gesture/2_scott_0_9_9/rep0/seq_*/*.npz"))
        assert [p.parent.name for p in seqs] == ["seq_0", "seq_1"]
        d = np.load(seqs[0])
        assert d["poses"].shape == (300, 55, 3) and d["trans"].shape == (300, 3)
        assert str(d["gender"]) == "male" and d["betas"].shape == (300,)
        assert np.abs(d["poses"][:, 22]).sum() == 0.0

    def test_refusals(self, tmp_path, monkeypatch):
        wavs, cfg = self._tree(tmp_path)
        with pytest.raises(SystemExit):
            cli.main(["--fn", "no_such_task"])
        # a configured checkpoint that is no checkpoint raises, never random weights
        monkeypatch.setenv("AMUSE_TPU_CKPT", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="neither a run directory"):
            cli.main(["--fn", "infer_gesture", "--cfg", str(cfg), "--wav-dir", str(wavs),
                      "--device", "cpu"])
        monkeypatch.delenv("AMUSE_TPU_CKPT")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                cli.main(["--fn", "infer_gesture", "--cfg", str(cfg), "--wav-dir", str(wavs)])
