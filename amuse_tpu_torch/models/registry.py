"""Model registry: the reference's ``allmodels`` dict (models/__init__.py:4-10).

Port of ``amuse_tpu/models/registry.py``: the same ten tags, mapped to the
port's classes. Constructors are lazy (the imports happen at lookup).
"""

from __future__ import annotations

from typing import Callable


def _ast():
    from amuse_tpu_torch.models.ast import ASTDisentangler

    return ASTDisentangler


def _motionprior():
    from amuse_tpu_torch.models.vae import MotionPrior

    return MotionPrior


def _denoiser():
    from amuse_tpu_torch.models.denoiser import Denoiser

    return Denoiser


def _raw_diffusion():
    from amuse_tpu_torch.models.raw_diffusion import RawPoseDenoiser

    return RawPoseDenoiser


def _wav_mfcc_legacy():
    from amuse_tpu_torch.models.audio_legacy import AutoEncoder3x

    return AutoEncoder3x


def _camn():
    from amuse_tpu_torch.models.legacy_family import CaMNPoseGenerator

    return CaMNPoseGenerator


def _faceformer():
    from amuse_tpu_torch.models.legacy_family import FaceformerDecoder

    return FaceformerDecoder


def _text_encoder():
    from amuse_tpu_torch.models.legacy_family import TextEncoder

    return TextEncoder


def _discriminator():
    from amuse_tpu_torch.models.legacy_family import ConvDiscriminator

    return ConvDiscriminator


def _actor_ae():
    from amuse_tpu_torch.models.actor import ActorAE

    return ActorAE


REGISTRY: dict[str, Callable] = {
    # flagship tags (reference: models/__init__.py allmodels)
    "wav_dtw_mfcc": _ast,            # stage-1 AST disentangler
    "motionprior": _motionprior,     # stage-2 VAE
    "latent_diffusion": _denoiser,   # stage-2 denoiser
    # the legacy "diffusion" family (unreachable from the reference CLI)
    "diffusion": _raw_diffusion,     # raw-pose MDM-style baseline
    "wav_mfcc": _wav_mfcc_legacy,    # pre-AST conv disentangler
    "camn_lstm": _camn,              # CaMN fusion LSTM generator
    "faceformer": _faceformer,       # autoregressive facial decoder
    "txt_gpt2": _text_encoder,       # frozen GPT-2 text conditioning
    "discriminator": _discriminator, # conv discriminator (empty upstream)
    "actor_ae": _actor_ae,           # ACTOR-style motion AE (unused upstream)
}


def get_model(tag: str):
    """Resolve a tag to its model class (raises KeyError on unknown tags)."""
    return REGISTRY[tag]()
