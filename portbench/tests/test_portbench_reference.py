"""The plain reference against the program at small widths on the CPU
(float32 both): the same raw weights and inputs give the same motion."""

from __future__ import annotations

import numpy as np
import torch

from amuse_tpu_torch.audio import fbank as port_fbank
from amuse_tpu_torch.core import rotations
from amuse_tpu_torch.infer.pipeline import GesturePipeline, PipelineParams
from amuse_tpu_torch.models.ast import ASTConfig
from amuse_tpu_torch.models.denoiser import DenoiserConfig
from amuse_tpu_torch.models.vae import PriorConfig
from portbench.inputs import make_weights, speech_like
from portbench.reference import fbank as ref_fbank
from portbench.reference import infer as ref
from portbench.systems.infer import served_types
from portbench.tests import tiny

CPU = torch.device("cpu")


def test_fbank_and_windows_match_the_program():
    wave = speech_like(3, 160_000, 16_000, 5, CPU)
    got = ref_fbank.fbank(wave)
    want = port_fbank.wav_chunk_to_fbank(wave)
    assert got.shape == (3, 1024, 128)
    assert (got - want).abs().max().item() < 1e-5
    clip = np.random.default_rng(0).normal(size=2 * 160_000 + 999).astype(np.float32)
    np.testing.assert_array_equal(ref_fbank.windows(clip), port_fbank.window_waveform(clip))


def test_rodrigues_matches_the_program():
    aa = torch.randn(1000, 3, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    got = ref.axis_angle_to_matrix(aa)
    assert (got - rotations.axis_angle_to_matrix(aa)).abs().max().item() < 1e-12


def test_the_stack_matches_the_program_at_small_widths():
    cfg = tiny.cell("infer.b32").config
    a, dn, pr = cfg["ast"], cfg["denoiser"], cfg["prior"]
    weights = make_weights(ref.param_shapes(cfg), served_types(cfg), 3, CPU)
    pipe = GesturePipeline(
        PipelineParams(ast=weights["ast"], prior=weights["prior"], denoiser=weights["denoiser"]),
        PriorConfig(latent_dim=pr["latent_dim"], ff_size=pr["ff_size"],
                    num_layers=pr["num_layers"], num_heads=pr["num_heads"]),
        DenoiserConfig(latent_dim=dn["latent_dim"], ff_size=dn["ff_size"],
                       num_layers=dn["num_layers"], num_heads=dn["num_heads"],
                       cond_dim=dn["cond_dim"]),
        ASTConfig(embed_dim=a["embed_dim"], depth=a["depth"], num_heads=a["num_heads"],
                  feature_dim=a["feature_dim"]),
        dtype=torch.float32, num_inference_steps=cfg["diffusion"]["num_inference_steps"],
        device="cpu")
    chunks = speech_like(3, 160_000, 16_000, 4, CPU)
    x_t = ref.initial_latents((3, 1, dn["latent_dim"]), 9, CPU)
    poses, trans = pipe.wav_to_motion(chunks.numpy(), initial_latents=x_t)
    mats, ref_trans = ref.Reference(cfg, weights, CPU).motion(chunks, x_t)
    err = ref.window_errors(ref.axis_angle_to_matrix(poses), trans, mats, ref_trans)
    assert err.max().item() < 1e-4, err
    # the control, one precision step down, lies far from both
    low = ref.Reference(cfg, weights, CPU, precision="control").motion(chunks, x_t)
    assert ref.window_errors(*low, mats, ref_trans).median().item() > 100 * err.max().item()


def test_param_shapes_are_the_programs_keys():
    cfg = tiny.cell("infer.b32").config
    shapes = ref.param_shapes(cfg)
    a, dn, pr = cfg["ast"], cfg["denoiser"], cfg["prior"]
    from amuse_tpu_torch.models.denoiser import Denoiser
    from amuse_tpu_torch.models.vae import MotionPrior

    with torch.device("meta"):
        den = Denoiser(DenoiserConfig(latent_dim=dn["latent_dim"], ff_size=dn["ff_size"],
                                      num_layers=dn["num_layers"], num_heads=dn["num_heads"],
                                      cond_dim=dn["cond_dim"])).state_dict()
        prior = MotionPrior(PriorConfig(latent_dim=pr["latent_dim"], ff_size=pr["ff_size"],
                                        num_layers=pr["num_layers"],
                                        num_heads=pr["num_heads"])).state_dict()
    assert {k: tuple(v.shape) for k, v in den.items()} == shapes["denoiser"]
    assert {k: tuple(v.shape) for k, v in prior.items()} == shapes["prior"]
    assert len(shapes["ast"]) == 3 * (5 + 12 * a["depth"] + 6)
