"""Immutable hierarchical configuration (the port's copy of amuse_tpu/cli/config.py).

Frozen dataclasses + a pure override merge: configs are values, never
state. The knob surface and the JSON layout are the JAX package's, so one
config file drives both CLIs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional


@dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/beat_english_v0.2.1"
    mosh_root: str = "data/moshed_v1/smplxflame_30"
    cache_dir: str = "processed/stage2_cache"
    stage1_dataset: str = "processed/stage1_quads.npz"
    smplx_model_dir: str = "data/smplx_models"  # SMPLX_{NEUTRAL,...}.npz
    fps: int = 30
    window_frames: int = 300
    sample_rate: int = 16_000
    # bvh2smplx_ external-tool assets (reference: configs/base_new.json
    # blender paths + the bundled SMPL-X T-pose rig / ARP bone-map preset)
    tpose_smplx_bvh: str = ""
    arp_preset: str = ""
    # external FGD embedder weights (train with --fn train_embedder). Empty
    # -> the checked-in synthetic-regime artefact (eval/embedder.py); the
    # eval report always carries the embedder's provenance string.
    embedder_path: str = ""
    # --fn blender_setup: directory the user drops addon archives into
    # (SMPL-X addon, ARP, retarget_bvh, mhx2, Stop-motion-OBJ - several are
    # licensed, so they cannot be bundled; see viz/blender_setup.py)
    blender_addons_dir: str = "data/blender_addons"
    # --fn render_baselines: root of <method_name>/<take_stem>.npz trees
    baselines_root: str = "data/baselines"


@dataclass(frozen=True)
class AudioStageConfig:
    """Stage-1 knobs (configs/base_new.json wav_dtw_mfcc block)."""

    batch_size: int = 1
    learning_rate: float = 1e-5
    weight_decay: float = 5e-7
    beta1: float = 0.95
    beta2: float = 0.999
    lr_decay_start_epoch: int = 5
    lr_decay_gamma: float = 0.85
    epochs: int = 25
    num_mel_bins: int = 128
    target_length: int = 1024
    freq_mask: int = 24
    time_mask: int = 96
    dataset_mean: float = -9.173025
    dataset_std: float = 5.062332
    frame_based_feats: bool = True
    noise: bool = True
    ablation: str = "full"  # full | emotion | identity | ast_baseline
    # AST backbone arch (ViT deit-base-384 defaults, audio_main_new.py:49)
    ast_embed_dim: int = 768
    ast_depth: int = 12
    ast_heads: int = 12
    ast_feature_dim: int = 256
    # tanh-approximate GELU in the ViT blocks (perf knob; default exact erf)
    gelu_tanh: bool = False


@dataclass(frozen=True)
class GestureStageConfig:
    """Stage-2 knobs (configs/base_new.json latent_diffusion +
    prior_emotional_fing.json + diff_latent_v2.json)."""

    batch_size: int = 32
    learning_rate: float = 1e-4
    epochs: int = 12_000
    model_save_freq: int = 200
    smplx_rep: str = "6D"  # 6D | 3D
    skip_trans: bool = False
    train_upper_body: bool = False
    vtex_displacement: bool = True
    # vertex subset of the displacement monitors (0 = full mesh), the DDIM
    # monitor's period in steps, and the C++ ABIN batch loader
    # (native/loader.py) in place of the Python cache reader
    vtex_subsample: int = 0
    monitor_every: int = 1
    native_loader: bool = False
    # prior / denoiser arch
    latent_dim: int = 128
    ff_size: int = 512
    num_layers: int = 9
    num_heads: int = 4
    dropout: float = 0.1
    cond_dim: int = 256
    # diffusion
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_inference_steps: int = 50


@dataclass(frozen=True)
class TestConfig:
    """Editing/eval tasks (configs/base_new.json test block)."""

    style_transfer: bool = False
    emotion_control: bool = False
    style_xemo_transfer: bool = False
    content_control: bool = False
    replication_times: int = 1
    actors: tuple = ()
    emotion: str = "happy"
    # eval_gesture: refuse to run APE/AVE/beat-align in rotation space (i.e.
    # require data.smplx_model_dir/SMPLX_NEUTRAL.npz) so rotation-space
    # numbers can never be published as position-space ones by accident
    strict_position_space: bool = False


@dataclass(frozen=True)
class VizConfig:
    """Blender render-scene knobs (viz/blender/render_npz.py). The reference
    hard-codes each combination as its own script under
    models/diffusion/viz/render_smpl*.py; here they are config rows."""

    # full = full-body studio (render_smpl.py), half = upper-body metallic
    # (render_smpl_half.py), show = half with pelvis framing
    # (render_smpl_show.py), plain = minimal sun-lit scene
    preset: str = "full"
    engine: str = "BLENDER_EEVEE"  # or CYCLES (render_smpl.py:141-152)
    resolution: int = 1024  # square, render_smpl.py:63-64
    samples: int = 0  # 0 -> engine default (EEVEE 128 taa / CYCLES 256)


@dataclass(frozen=True)
class EmbedderTrainConfig:
    """--fn train_embedder: the external FGD feature extractor (an AE over
    ground-truth motion windows only - see eval/embedder.py)."""

    epochs: int = 50
    learning_rate: float = 1e-3
    latent_dim: int = 64
    channels: tuple = (128, 64)
    batch_size: int = 32


@dataclass(frozen=True)
class Config:
    data: DataConfig = DataConfig()
    audio: AudioStageConfig = AudioStageConfig()
    gesture: GestureStageConfig = GestureStageConfig()
    embedder: EmbedderTrainConfig = EmbedderTrainConfig()
    test: TestConfig = TestConfig()
    viz: VizConfig = VizConfig()
    seed: int = 2021
    debug: bool = False
    out_dir: str = "runs"
    dtype: str = "bfloat16"
    resume: str = ""  # checkpoint dir to resume params from


def _merge(cfg: Any, overrides: dict) -> Any:
    """Pure recursive override: returns a NEW frozen config.

    Unknown keys are an error (typo protection); keys starting with "_"
    are documentation and ignored (JSON has no comments).
    """
    known = {f.name for f in dataclasses.fields(cfg)}
    unknown = [k for k in overrides if k not in known and not k.startswith("_")]
    if unknown:
        raise SystemExit(
            f"unknown config key(s) {unknown} for {type(cfg).__name__}; "
            f"valid keys: {sorted(known)}"
        )
    updates = {}
    for f in dataclasses.fields(cfg):
        if f.name not in overrides:
            continue
        v = overrides[f.name]
        cur = getattr(cfg, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[f.name] = _merge(cur, v)
        elif isinstance(cur, tuple):
            # a bare string override of a tuple field means ONE element (or
            # a comma-separated list) - tuple('wayne') would silently become
            # ('w','a','y','n','e') and e.g. test.actors lookups find nothing
            if isinstance(v, str):
                v = [s for s in v.split(",") if s]
            updates[f.name] = tuple(v)
        else:
            updates[f.name] = v
    return dataclasses.replace(cfg, **updates)


def load_config(
    path: Optional[str] = None, overrides: Optional[dict] = None
) -> Config:
    """Base defaults <- optional JSON file <- optional override dict."""
    cfg = Config()
    if path:
        cfg = _merge(cfg, json.loads(Path(path).read_text()))
    if overrides:
        cfg = _merge(cfg, overrides)
    return cfg


def dump_config(cfg: Config) -> str:
    """Experiment snapshot (the reference's _dump_args, trainer.py:1100-1116)."""
    return json.dumps(dataclasses.asdict(cfg), indent=1)


def parse_cli_overrides(pairs: list[str]) -> dict:
    """["gesture.epochs=100", "debug=true"] -> nested override dict."""
    out: dict = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got: {pair!r}")
        key, _, raw = pair.partition("=")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out
