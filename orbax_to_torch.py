"""Convert a JAX run's orbax checkpoints into the PyTorch port's checkpoints.

    python orbax_to_torch.py --src <jax run>/checkpoints --dst <port run>/checkpoints
    python orbax_to_torch.py --src ... --dst ... --step 12   # one step only

Run it where the JAX package (``amuse_tpu`` with orbax) is installed: the TPU
host that trained, or any machine with the JAX package. Each step directory
of ``--src`` (all of them unless ``--step``) is restored template-free with
``amuse_tpu.train.checkpoint.CheckpointManager``: a stage-1 run (``params``
holding ``emo_enc``, ``sty_enc``, ``con_enc``, ...) or an LPDM run
(``{"prior", "denoiser"}``), as a full train state (parameters, the
``FusedAdamState`` moments, ``count`` and ``lr``, and the step) or, from
checkpoints older than that format, bare parameters. The tree goes through
``amuse_tpu_torch.convert.audio_train_state_from_jax`` or
``gesture_train_state_from_jax`` and is written by the port's
``train.checkpoint.CheckpointManager`` as ``<dst>/step_<s:08d>/state.pt``,
with ``metadata.json`` copied unchanged (so ``best_step`` reads the same
metrics).

The port's modules are built on the ``meta`` device, which allocates
nothing (the flagship stage-1 model has 424.7 M parameters), to give the
order of the optimizer's parameters. Their widths and depths are read from
the tree's shapes, not from a config file; every converted tensor's shape is
then checked against the module's.

The port then uses the result as a run of its own, on the card:
``--fn train_audio`` / ``--fn train_gesture`` with ``--set resume=<dst>``,
and ``--fn infer_gesture`` / ``edit_gesture`` with ``AMUSE_TPU_CKPT=<LPDM
dst>`` and ``AMUSE_TPU_AST_CKPT=<stage-1 dst>``.

This is the one file outside ``tests/`` that imports both packages.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from dataclasses import replace
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

STAGE1_KEYS = {"emo_enc", "sty_enc", "con_enc"}
LPDM_KEYS = {"prior", "denoiser"}


def _params_of(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree and "opt_state" in tree else tree


def kind_of(tree: Mapping) -> str:
    """"stage1" or "lpdm", by the keys under ``params`` (or of bare parameters)."""
    keys = set(_params_of(tree))
    if LPDM_KEYS <= keys:
        return "lpdm"
    if STAGE1_KEYS <= keys:
        return "stage1"
    raise ValueError(f"neither a stage-1 nor an LPDM tree: parameters {sorted(keys)}")


def _count(p: Mapping, stem: str) -> int:
    return sum(1 for k in p if k.startswith(stem) and k[len(stem):].isdigit())


def _shape(x) -> tuple:
    return tuple(np.shape(x))


def stage1_state_on_meta(params: Mapping):
    """The port's ``AudioTrainState`` on ``meta`` at the tree's widths."""
    from amuse_tpu_torch.models.ast import ASTConfig, ASTDisentangler
    from amuse_tpu_torch.train import audio as ta

    enc = params["emo_enc"]
    patch_pixels, embed = _shape(enc["patch_proj"]["kernel"])
    patch = int(round(patch_pixels ** 0.5))
    patches = _shape(enc["pos_embed"])[1] - 2
    frames_bins = _shape(params["decoder"]["proj2"]["kernel"])[1]
    base = ASTConfig(patch=patch, embed_dim=embed, depth=_count(enc, "block_"),
                     num_heads=1, feature_dim=_shape(enc["feature_fc"]["kernel"])[1])
    # (frames, bins): their product is the decoder's output, their patches the
    # positional table's rows; the fbank's 128 bins where several fit
    fits = [replace(base, input_tdim=frames_bins // f, input_fdim=f)
            for f in range(patch, frames_bins + 1) if frames_bins % f == 0]
    fits = [c for c in fits if c.num_patches == patches]
    if not fits:
        raise ValueError(f"no (frames, bins) with {frames_bins} pixels gives {patches} patches")
    cfg = min(fits, key=lambda c: abs(c.input_fdim - 128))
    fusion_dim = _shape(params["fusion"]["fc"]["kernel"])[1]
    with torch.device("meta"):
        model = ASTDisentangler(cfg, fusion_dim=fusion_dim)
    return ta.AudioTrainState(model, ta.make_optimizer(model, ta.AudioTrainConfig()))


def lpdm_state_on_meta(params: Mapping):
    """The port's ``GestureTrainState`` on ``meta`` at the tree's widths."""
    from amuse_tpu_torch.models.denoiser import Denoiser, DenoiserConfig
    from amuse_tpu_torch.models.vae import MotionPrior, PriorConfig
    from amuse_tpu_torch.train import gesture as tg

    enc, den = params["prior"]["encoder"], params["denoiser"]
    nfeats, d = _shape(enc["skel_embedding"]["kernel"])
    stack = enc["encoder"]
    prior_cfg = PriorConfig(
        nfeats=nfeats, latent_tokens=_shape(enc["dist_tokens"])[0] // 2, latent_dim=d,
        ff_size=_shape(stack["mid"]["ffn"]["linear1"]["kernel"])[1],
        num_layers=2 * _count(stack, "in_") + 1, num_heads=1,
        max_len=_shape(enc["pos"]["pe"])[0])
    den_stack = den["encoder"]
    den_cfg = DenoiserConfig(
        latent_dim=_shape(den["pos"]["pe"])[1],
        ff_size=_shape(den_stack["mid"]["ffn"]["linear1"]["kernel"])[1],
        num_layers=2 * _count(den_stack, "in_") + 1, num_heads=1,
        cond_dim=_shape(den["proj_con"]["linear"]["kernel"])[0],
        max_len=_shape(den["pos"]["pe"])[0])
    with torch.device("meta"):
        prior, denoiser = MotionPrior(prior_cfg), Denoiser(den_cfg)
    return tg.GestureTrainState(prior, denoiser,
                                tg.make_optimizer(prior, denoiser, tg.GestureTrainConfig()))


def convert_tree(tree: Mapping, label: str = "") -> dict:
    """A restored orbax tree -> the port's train-state dict (``state.pt``)."""
    from amuse_tpu_torch import convert

    if kind_of(tree) == "lpdm":
        state = lpdm_state_on_meta(_params_of(tree))
        out = convert.gesture_train_state_from_jax(tree, state)
        pairs = [(out["params"][k], getattr(state, k)) for k in ("prior", "denoiser")]
    else:
        state = stage1_state_on_meta(_params_of(tree))
        out = convert.audio_train_state_from_jax(tree, state)
        pairs = [(out["model"], state.model)]
    for sd, module in pairs:
        want = module.state_dict()
        for k, v in sd.items():
            if v.shape != want[k].shape:
                raise ValueError(f"{k}: converted {tuple(v.shape)}, the port's "
                                 f"{tuple(want[k].shape)}")
    if "optimizer" not in out:
        print(f"[convert]{label} params ONLY (old checkpoint format; optimizer moments reset)")
    return out


def convert_run(src, dst, step: Optional[int] = None) -> list[int]:
    """Every step of ``src`` (or ``step``) into ``dst``; -> the steps written."""
    from amuse_tpu.train.checkpoint import CheckpointManager as OrbaxManager

    from amuse_tpu_torch.train.checkpoint import CheckpointManager

    jax_mgr, port_mgr = OrbaxManager(src), CheckpointManager(dst)
    steps = jax_mgr.steps() if step is None else [step]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {src}")
    for s in steps:
        tree, _ = jax_mgr.restore(s)
        out = convert_tree(tree, f" step {s}:")
        path = port_mgr.save(s, out)
        shutil.copyfile(jax_mgr._path(s) / "metadata.json", path / "metadata.json")
        print(f"[convert] {jax_mgr._path(s)} -> {path / 'state.pt'} ({kind_of(tree)}, "
              f"{'full train state' if 'optimizer' in out else 'bare params'})")
    return steps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True, help="the JAX run's checkpoints directory")
    parser.add_argument("--dst", required=True, help="the port's checkpoints directory to write")
    parser.add_argument("--step", type=int, default=None, help="convert this step only")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    convert_run(args.src, args.dst, args.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
