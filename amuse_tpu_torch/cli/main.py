"""CLI of the PyTorch/CUDA port.

    python -m amuse_tpu_torch.cli.main
        --fn {infer_gesture,edit_gesture,prepare_data,train_audio,train_gesture,
              eval_gesture,train_embedder}
        [--cfg tiny.json] [--set key=value ...] [--wav-dir DIR] [--device cuda|cpu]

``infer_gesture`` turns every WAV under ``--wav-dir`` into SMPL-X npz files,
one per 10 s window, under ``<out_dir>/<timestamp>/gesture/<stem>/rep<r>/seq_<i>/``
(the JAX CLI's layout and per-WAV seed folding).

``edit_gesture`` runs the editing tasks the ``test.*`` flags select
(emotion_control, style_transfer, style_Xemo_transfer) on the BEAT tree at
``data.data_root``, and the demo emotion swap over the first two WAVs of
``viz_dump/test/e_speech``, each replication under ``rep<r>/``; it writes
npz files only (rendering is not ported).

``prepare_data`` builds the stage-2 window cache (frozen-AST features, one
``encode_audio`` per take) at ``data.cache_dir`` and the stage-1 quad
dataset at ``data.stage1_dataset``, each skipped when already built.

``train_audio`` trains the stage-1 AST disentangler on the quad dataset at
``data.stage1_dataset``, one device, and writes ``metrics.jsonl`` and a
checkpoint per epoch under ``<out_dir>/<timestamp>/`` unless ``debug``;
``resume=<checkpoint dir>`` continues a run.

``train_gesture`` trains the stage-2 motion prior and denoiser (LPDM) on the
window cache at ``data.cache_dir``, one device, with the DDIM monitor (K3 on
the card) every ``gesture.monitor_every`` steps and the SMPL-X vertex
monitors when ``data.smplx_model_dir/SMPLX_NEUTRAL.npz`` exists; it writes
``metrics.jsonl`` and a checkpoint every ``gesture.model_save_freq`` epochs,
which ``AMUSE_TPU_CKPT`` loads into ``infer_gesture``/``edit_gesture``.
With ``gesture.native_loader`` its batches come from the C++ ABIN loader
(``native/loader.py``) over ``<cache_dir>/train.abin``, built from the
cache when missing or older than its manifest.

``eval_gesture`` scores the pipeline on the window cache (FGD in the
prior's latent space and in the external embedder's, diversity, APE/AVE
and beat alignment in SMPL-X position space when
``data.smplx_model_dir/SMPLX_NEUTRAL.npz`` exists, else in rotation space,
R-precision), one K3 launch per batch, and writes ``eval_results.json``
unless ``debug``. ``train_embedder`` trains that external embedder on the
cache's ground-truth windows and writes ``embedder.npz`` (the JAX
package's format), which ``data.embedder_path`` selects.

Weights come from ``AMUSE_TPU_CKPT`` (and ``AMUSE_TPU_AST_CKPT``), read by
``utils/checkpoint_io.py``; with neither set they are random, seeded by
``cfg.seed``. The device defaults to ``cuda`` and the run fails without a
GPU. The other tasks (``bvh2smplx_``, ``render_gt``, ``render_baselines``,
``blender_setup``) are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import time
import zlib
from pathlib import Path

import torch

TASK_NAMES = (
    "blender_setup", "bvh2smplx_", "edit_gesture", "eval_gesture", "infer_gesture",
    "prepare_data", "render_baselines", "render_gt", "train_audio", "train_embedder",
    "train_gesture",
)


def _model_cfgs(cfg):
    """Config dataclasses -> the port's model configs."""
    from amuse_tpu_torch.core.motion import FEATS_6D, RAW_FEATS
    from amuse_tpu_torch.models.ast import ASTConfig
    from amuse_tpu_torch.models.denoiser import DenoiserConfig
    from amuse_tpu_torch.models.vae import PriorConfig

    g, a = cfg.gesture, cfg.audio
    if g.smplx_rep not in ("6D", "3D"):
        raise ValueError(f"gesture.smplx_rep must be '6D' or '3D', got {g.smplx_rep!r}")
    if g.skip_trans and g.smplx_rep != "3D":
        raise ValueError("gesture.skip_trans requires gesture.smplx_rep='3D'")
    if g.train_upper_body:
        raise NotImplementedError(
            "gesture.train_upper_body reproduces a broken reference path; "
            "train with smplx_rep='3D' instead"
        )
    nfeats = (FEATS_6D if g.smplx_rep == "6D" else RAW_FEATS) - (3 if g.skip_trans else 0)
    prior_cfg = PriorConfig(
        nfeats=nfeats, latent_dim=g.latent_dim, ff_size=g.ff_size,
        num_layers=g.num_layers, num_heads=g.num_heads, dropout=g.dropout,
        window=cfg.data.window_frames,
    )
    den_cfg = DenoiserConfig(
        latent_dim=g.latent_dim, ff_size=g.ff_size, num_layers=g.num_layers,
        num_heads=g.num_heads, dropout=g.dropout, cond_dim=g.cond_dim,
    )
    ast_cfg = ASTConfig(
        input_tdim=a.target_length, input_fdim=a.num_mel_bins, embed_dim=a.ast_embed_dim,
        depth=a.ast_depth, num_heads=a.ast_heads, feature_dim=a.ast_feature_dim,
        gelu_tanh=a.gelu_tanh,
    )
    return prior_cfg, den_cfg, ast_cfg


def _make_pipeline(cfg, device):
    from amuse_tpu_torch.infer.pipeline import GesturePipeline, init_random_params
    from amuse_tpu_torch.utils.checkpoint_io import load_pipeline_params

    prior_cfg, den_cfg, ast_cfg = _model_cfgs(cfg)
    params = load_pipeline_params()
    if params is None:
        print("[pipeline] no checkpoint configured; using random weights")
        params = init_random_params(cfg.seed, prior_cfg, den_cfg, ast_cfg)
    return GesturePipeline(
        params, prior_cfg, den_cfg, ast_cfg,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        num_inference_steps=cfg.gesture.num_inference_steps,
        frame_based_feats=cfg.audio.frame_based_feats,
        smplx_rep=cfg.gesture.smplx_rep,
        skip_trans=cfg.gesture.skip_trans,
        device=device,
    )


def _setup(cfg) -> Path:
    from amuse_tpu_torch.cli.config import dump_config

    run_dir = Path(cfg.out_dir) / time.strftime("%Y%m%d-%H%M%S")
    if not cfg.debug:
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "experiment_args.json").write_text(dump_config(cfg))
    return run_dir


def task_prepare_data(cfg, device: torch.device):
    """Stage-2 window cache (MoSh motion + frozen-AST features) and the
    stage-1 quad dataset; nothing is written when the data root is empty."""
    from amuse_tpu_torch.data import beat, stage1

    takes = beat.discover(Path(cfg.data.data_root), Path(cfg.data.mosh_root))
    subset = beat.stage2_subset(takes)
    print(f"[prepare_data] {len(subset)} stage-2 takes discovered")
    if not takes:
        print(f"[prepare_data] WARNING: nothing under {cfg.data.data_root} - check "
              "data.data_root/data.mosh_root; not writing empty datasets")
        return
    if not subset:
        # no 0-window manifest (it would short-circuit every later build); an
        # audio-only corpus is still a stage-1 corpus, so the quads still build
        print(f"[prepare_data] WARNING: takes found but no stage-2 subset - check "
              f"data.mosh_root ({cfg.data.mosh_root}); stage-2 cache not built "
              "(stage-1 dataset still builds)")
    else:
        _build_stage2(cfg, subset, device)

    out = Path(cfg.data.stage1_dataset)
    provenance = stage1.takes_provenance(takes)
    if stage1.dataset_is_current(out, provenance):
        print(f"[prepare_data] stage-1 dataset current, skipping -> {out} (identity-only "
              "check: delete the npz to force a rebuild after editing a wav/CSV in place)")
        return
    per_take = stage1.fbanks_per_take(takes, stage1.device_fbank_fn(device))
    train = stage1.build_quads(per_take, "train")
    val = stage1.build_quads(per_take, "val")
    out.parent.mkdir(parents=True, exist_ok=True)
    stage1.save_dataset(out, train, val, provenance)
    print(f"[prepare_data] stage-1 quads: train {train['emo_id'].shape[0]}, "
          f"val {val['emo_id'].shape[0]} -> {out}")


def _build_stage2(cfg, subset, device):
    """The stage-2 leg of prepare_data: one encode_audio call per take on one
    device (the JAX CLI shards this pass over a mesh)."""
    from amuse_tpu_torch.data import cache

    pipe = _make_pipeline(cfg, device)

    def encode(chunks):
        return {k: v.cpu().numpy() for k, v in pipe.encode_audio(chunks).items()}

    ast_source = os.environ.get("AMUSE_TPU_CKPT") or "random-weights"
    if ast_source == "random-weights":
        print("[prepare_data] WARNING: building AST features with RANDOM weights "
              "(set AMUSE_TPU_CKPT for real conditioning)")
    cache.build_stage2_cache(subset, Path(cfg.data.cache_dir), encode,
                             window_frames=cfg.data.window_frames, ast_source=ast_source)


def _export_edit_results(run_dir: Path, task_name: str, results: dict) -> None:
    """One npz per window and variant, jaw zeroed, under
    ``<run_dir>/<task_name>/<source>/<variant>/seq_<i>/``."""
    from amuse_tpu_torch.core.motion import zero_jaw
    from amuse_tpu_torch.viz.export import export_windows

    for source_key, variants in results.items():
        for variant, (poses, trans) in variants.items():
            export_windows(run_dir / task_name / source_key / variant,
                           {"poses": zero_jaw(torch.from_numpy(poses)).numpy(),
                            "trans": trans, "fps": 30.0},
                           subject=source_key.split("_")[0], stem=variant)
    print(f"[edit] {task_name}: {len(results)} sources -> {run_dir / task_name}")


def task_edit_gesture(cfg, device: torch.device):
    """The editing tasks the ``cfg.test`` flags select, on the BEAT tree, and
    the demo emotion swap over two WAVs under viz_dump/test/e_speech.

    Each replication reruns every task with seed ``cfg.seed + rep``;
    style_Xemo_transfer also redraws which of an emotion's two takes stands
    for it. A missing corner take skips only that task.
    """
    import numpy as np

    from amuse_tpu_torch.audio.wavio import load_wav_resampled
    from amuse_tpu_torch.data import beat, eval_sets
    from amuse_tpu_torch.infer import editing
    from amuse_tpu_torch.viz.export import export_windows

    run_dir = _setup(cfg)
    pipe = _make_pipeline(cfg, device)
    t = cfg.test
    dataset_tasks = t.emotion_control or t.style_transfer or t.style_xemo_transfer
    reps = max(1, t.replication_times)
    data_root = Path(cfg.data.data_root)
    for rep in range(reps):
        seed_r = cfg.seed + rep
        if reps > 1:
            print(f"[edit] replication {rep + 1}/{reps} (seed {seed_r})")
        if dataset_tasks and data_root.exists():
            takes = beat.discover(data_root, Path(cfg.data.mosh_root))

            def encode_item(item):
                return editing.encode_take(pipe, item.actor, item.take, 0, item.waveform,
                                           item.motion, seed_r)

            if t.emotion_control and t.actors:
                items = eval_sets.emotion_control_set(takes, t.actors[0])
                _export_edit_results(
                    run_dir, f"emotion_control/rep{rep}",
                    editing.emotion_control(pipe, [encode_item(i) for i in items], seed_r))
            if t.style_transfer and len(t.actors) >= 2:
                a1, a2 = eval_sets.style_transfer_set(takes, t.actors[0], t.actors[1],
                                                      t.emotion)
                _export_edit_results(
                    run_dir, f"style_transfer/rep{rep}",
                    editing.style_transfer(pipe, [encode_item(i) for i in a1],
                                           [encode_item(i) for i in a2], seed_r))
            if t.style_xemo_transfer and len(t.actors) >= 2:
                try:
                    corners = eval_sets.style_xemo_set(
                        takes, t.actors[0], t.actors[1], "angry", t.emotion,
                        rng=np.random.default_rng(seed_r))
                except FileNotFoundError as e:  # skips this task only
                    print(f"[edit] style_Xemo_transfer skipped: {e}")
                else:
                    enc = {k: encode_item(v) for k, v in corners.items()}
                    _export_edit_results(
                        run_dir, f"style_Xemo_transfer/rep{rep}",
                        editing.style_xemo_transfer(pipe, enc["a1_e1"], enc["a1_e2"],
                                                    enc["a2_e1"], enc["a2_e2"], seed_r))

        demo_dir = Path("viz_dump/test/e_speech")
        wavs = sorted(demo_dir.glob("*.wav"))
        if len(wavs) >= 2:
            out = editing.demo_emotion_swap(pipe, load_wav_resampled(wavs[0]),
                                            load_wav_resampled(wavs[1]), seed_r)
            for name, (poses, trans) in out.items():
                export_windows(run_dir / "e_gesture" / f"rep{rep}" / name,
                               {"poses": poses, "trans": trans, "fps": 30.0}, stem=name)
            print(f"[edit] demo emotion swap -> {run_dir / 'e_gesture' / f'rep{rep}'}")
        elif rep == 0 and not dataset_tasks:
            print(f"[edit] no demo wavs under {demo_dir} and no cfg.test task enabled")
            break
    print("[edit] rendering (Blender, ffmpeg) is not ported yet; wrote the npz files only")


def task_train_audio(cfg, device: torch.device):
    """Stage-1 AST disentangler training (reference: trainer.train_dtw_ast)."""
    import dataclasses

    import numpy as np

    from amuse_tpu_torch.data import stage1
    from amuse_tpu_torch.eval.classification import epoch_stats
    from amuse_tpu_torch.train import audio as ta
    from amuse_tpu_torch.train.checkpoint import CheckpointManager, restore_train_state
    from amuse_tpu_torch.utils.logging import RunLogger

    run_dir = _setup(cfg)
    logger = RunLogger(None if cfg.debug else run_dir)
    a = cfg.audio
    tcfg = ta.AudioTrainConfig(
        learning_rate=a.learning_rate, weight_decay=a.weight_decay, beta1=a.beta1,
        beta2=a.beta2, lr_decay_start_epoch=a.lr_decay_start_epoch,
        lr_decay_gamma=a.lr_decay_gamma, epochs=a.epochs,
        frame_based_feats=a.frame_based_feats, freq_mask=a.freq_mask,
        time_mask=a.time_mask, noise_aug=a.noise,
    )
    train, val = stage1.load_dataset(Path(cfg.data.stage1_dataset))
    # the same AST config the inference pipeline builds from cfg
    _, _, ast_cfg = _model_cfgs(cfg)
    bsz = max(1, a.batch_size)
    n_train = int(train["emo_id"].shape[0])
    if n_train == 0:
        raise RuntimeError("stage-1 dataset has no training quads - nothing would train")
    if n_train < bsz:  # else an epoch would take no step and checkpoint random weights
        print(f"[AST-T] batch {bsz} > dataset {n_train}; clamped to {n_train}")
        bsz = n_train
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if ta.remat_needed(ast_cfg, bsz, dtype, device):
        ast_cfg = dataclasses.replace(ast_cfg, remat=True)
        print(f"[AST-T] {bsz} quads per step: remat enabled (without it a step would take "
              f"~{ta.step_peak_bytes(ast_cfg, bsz, dtype) / 2**30:.1f} GiB, over 90% of the card)")
    state = ta.init_state(cfg.seed, tcfg, dtype, ast_cfg, device)
    start_epoch = 0
    if cfg.resume:
        state, start_epoch = restore_train_state(cfg.resume, state, "AST-T")
    ckpt = None if cfg.debug else CheckpointManager(run_dir / "checkpoints")
    step_fn, set_lr = ta.make_train_step(tcfg)

    @torch.no_grad()
    def validate() -> dict:
        """Emotion/speaker stats over the val quads (AST_EVP.py:331-430)."""
        n_val = int(val["emo_id"].shape[0])
        if n_val == 0:
            return {}
        state.model.eval()
        emo_logits, sty_logits, emo_lab, sty_lab = [], [], [], []
        for batch in stage1.batches(val, min(bsz, n_val)):
            fb = torch.as_tensor(batch["fbanks"]).to(device)
            enc = state.model.encode(fb.reshape(-1, *fb.shape[2:]), tcfg.frame_based_feats)
            emo_logits.append(enc["emo"]["logits"].cpu())
            sty_logits.append(enc["sty"]["logits"].cpu())
            # (B, 4, ...) flattens batch-major: labels repeat 4x per sample
            emo_lab.append(np.repeat(batch["emo_id"], 4))
            sty_lab.append(np.stack([batch["a1_id"], batch["a1_id"], batch["a2_id"],
                                     batch["a2_id"]], axis=1).reshape(-1))
        stats = epoch_stats(torch.cat(emo_logits), torch.from_numpy(np.concatenate(emo_lab)),
                            torch.cat(sty_logits), torch.from_numpy(np.concatenate(sty_lab)))
        return {"val_emo_acc": stats["emo_stats"]["acc"],
                "val_sty_acc": stats["subject_stats"]["acc"],
                "val_emo_f1": stats["emo_stats"]["f1_micro"]}

    for epoch in range(start_epoch, tcfg.epochs):
        set_lr(state, epoch)
        t0, logs = time.time(), {}
        # epoch-keyed shuffle: a resumed run sees the batch order of an unbroken one
        rng = np.random.default_rng([cfg.seed, epoch])
        for i, batch in enumerate(stage1.batches(train, bsz, rng)):
            gen = ta.step_generator(cfg.seed, epoch, i, device)
            logs = step_fn(state, ta.batch_to_device(batch, device), gen)
        metrics = {f"train_{k}": float(v) for k, v in logs.items()}
        metrics.update(validate())
        logger.log(epoch, metrics)
        print(f"[AST-T] epoch {epoch + 1}/{tcfg.epochs} ({time.time() - t0:.1f}s): "
              + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if ckpt:  # full state: parameters, Adam moments, step
            ckpt.save(epoch + 1, state.state_dict(), metrics)


def task_train_gesture(cfg, device: torch.device):
    """Stage-2 LPDM joint training (reference: trainer.train_prior_latdiff_
    forward_backward_v2), one device."""
    import dataclasses

    import numpy as np

    from amuse_tpu_torch.core import smplx as smplx_mod
    from amuse_tpu_torch.data.cache import WindowCache, betas_for_actor_ids
    from amuse_tpu_torch.data.prefetch import prefetch_to_device
    from amuse_tpu_torch.train import gesture as tg
    from amuse_tpu_torch.train.audio import step_generator
    from amuse_tpu_torch.train.checkpoint import CheckpointManager, restore_train_state
    from amuse_tpu_torch.utils.logging import RunLogger

    g = cfg.gesture
    run_dir = _setup(cfg)
    logger = RunLogger(None if cfg.debug else run_dir)
    tcfg = tg.GestureTrainConfig(
        learning_rate=g.learning_rate, batch_size=max(1, g.batch_size), epochs=g.epochs,
        num_inference_steps=g.num_inference_steps, monitor_every=max(1, g.monitor_every),
        vtex_displacement=g.vtex_displacement, checkpoint_every=g.model_save_freq,
        smplx_rep=g.smplx_rep, skip_trans=g.skip_trans,
    )
    smplx_path = Path(cfg.data.smplx_model_dir) / "SMPLX_NEUTRAL.npz"
    smplx_model = smplx_mod.load_model(smplx_path) if smplx_path.exists() else None
    if g.vtex_displacement and smplx_model is None:
        print("[LPDM-T] SMPL-X model npz not found; vertex monitor disabled")
    if smplx_model is not None and g.vtex_subsample > 0:
        smplx_model = smplx_mod.subsample_vertices(smplx_model, g.vtex_subsample,
                                                   seed=cfg.seed)
        print(f"[LPDM-T] vertex monitor subsampled to {smplx_model.num_vertices} "
              "vertices (exact per-vertex, unbiased mean)")
    if smplx_model is not None:
        smplx_model = smplx_model.to(device)

    prior_cfg, den_cfg, _ = _model_cfgs(cfg)
    data = WindowCache(Path(cfg.data.cache_dir))
    if len(data) == 0:
        raise RuntimeError(f"window cache {cfg.data.cache_dir} is empty - nothing would train")
    if len(data) < tcfg.batch_size:  # else an epoch would take no step
        print(f"[LPDM-T] batch {tcfg.batch_size} > cache {len(data)}; clamped to {len(data)}")
        tcfg = dataclasses.replace(tcfg, batch_size=len(data))
    # two step functions: with the DDIM/vertex monitor (every monitor_every-th
    # step) and without; the monitors carry no gradient
    step_mon = tg.make_train_step(prior_cfg, den_cfg, tcfg, smplx_model, with_monitor=True)
    step_fast = (tg.make_train_step(prior_cfg, den_cfg, tcfg, smplx_model, with_monitor=False)
                 if tcfg.monitor_every > 1 else step_mon)
    state = tg.init_state(cfg.seed, prior_cfg, den_cfg, tcfg, device)
    start_epoch = 0
    if cfg.resume:
        state, start_epoch = restore_train_state(cfg.resume, state, "LPDM-T")
    ckpt = None if cfg.debug else CheckpointManager(run_dir / "checkpoints")

    native = None
    if g.native_loader:  # a failed build raises; there is no fallback loader
        from amuse_tpu_torch.native import loader as native_mod

        abin = Path(cfg.data.cache_dir) / "train.abin"
        manifest = Path(cfg.data.cache_dir) / "manifest.json"
        # a rebuilt or merged cache invalidates the file derived from it
        if not abin.exists() or abin.stat().st_mtime < manifest.stat().st_mtime:
            native_mod.cache_to_abin(cfg.data.cache_dir, abin,
                                     fields=("motion", "actor_id", "con", "emo", "sty"))
        native = native_mod.NativeWindowLoader(abin)
        print(f"[LPDM-T] native ABIN loader: {len(native)} windows")

    def host_batches(epoch):
        # epoch-keyed shuffle: a resumed run sees the batch order of an unbroken one
        if native is not None:
            batches = native.epoch(tcfg.batch_size, seed=cfg.seed * 100_003 + epoch)
        else:
            batches = data.batches(tcfg.batch_size, np.random.default_rng([cfg.seed, epoch]))
        for b in batches:
            yield {"motion": b["motion"], "con": b["con"], "emo": b["emo"], "sty": b["sty"],
                   "betas": betas_for_actor_ids(b["actor_id"])}

    for epoch in range(start_epoch, tcfg.epochs):
        t0, logs = time.time(), {}
        for i, batch in enumerate(prefetch_to_device(host_batches(epoch), 2, device)):
            fn = step_mon if i % tcfg.monitor_every == 0 else step_fast
            logs = fn(state, batch, step_generator(cfg.seed, epoch, i, device))
        metrics = {f"train_{k}": float(v) for k, v in logs.items()}
        logger.log(epoch, metrics)
        print(f"[LPDM-T] epoch {epoch + 1}/{tcfg.epochs} ({time.time() - t0:.1f}s): "
              + ", ".join(f"{k}={v:.6f}" for k, v in metrics.items()))
        if ckpt and (epoch + 1) % tcfg.checkpoint_every == 0:
            # full state: parameters, AdamW moments, step
            ckpt.save(epoch + 1, state.state_dict(), metrics)


def task_eval_gesture(cfg, device: torch.device):
    """Quantitative eval over the window cache: FGD, diversity, APE/AVE, beat
    alignment and R-precision, the metrics the reference published only in
    its paper."""
    import json

    from amuse_tpu_torch.core import smplx as smplx_mod
    from amuse_tpu_torch.data.cache import WindowCache
    from amuse_tpu_torch.eval import embedder as emb
    from amuse_tpu_torch.eval.runner import evaluate_cache

    run_dir = _setup(cfg)
    # position-space APE/AVE/beat alignment through the SMPL-X FK when the
    # body model exists, labelled rotation space otherwise; checked before
    # anything is built, so that strict runs fail fast
    smplx_path = Path(cfg.data.smplx_model_dir) / "SMPLX_NEUTRAL.npz"
    smplx_model = smplx_mod.load_model(smplx_path) if smplx_path.exists() else None
    if smplx_model is None:
        msg = (
            f"[eval] SMPL-X body model NOT loaded (looked for {smplx_path}).\n"
            "[eval] APE/AVE/beat-align will run in ROTATION space - these "
            "numbers are NOT comparable to position-space (paper) metrics.\n"
            "[eval] To fix: download SMPLX_NEUTRAL.npz from smpl-x.is.tue.mpg.de "
            f"(licensed, not vendorable) into {cfg.data.smplx_model_dir}/, or "
            "set data.smplx_model_dir. The report will be labelled "
            'metric_space: "rotation".'
        )
        if cfg.test.strict_position_space:
            raise SystemExit(msg + "\n[eval] test.strict_position_space=true: refusing to "
                             "produce rotation-space numbers.")
        print(msg)
    else:
        print(f"[eval] SMPL-X body model loaded from {smplx_path}; "
              "APE/AVE/beat-align in position space (FK joints)")
        smplx_model = smplx_model.to(device)
    emb_path = Path(cfg.data.embedder_path) if cfg.data.embedder_path else emb.DEFAULT_WEIGHTS
    embedder = None
    if emb_path.exists():
        embedder = emb.load(emb_path)
        print(f"[eval] external FGD embedder: {emb_path} ({embedder[2]})")
    elif cfg.data.embedder_path:
        # configured but absent: a config error, not a soft skip
        raise SystemExit(
            f"[eval] data.embedder_path={cfg.data.embedder_path} does not "
            "exist (train one with --fn train_embedder, or unset the knob "
            "to fall back to the bundled synthetic-regime weights)")
    else:
        print(f"[eval] no external embedder at {emb_path}; fgd_embedder "
              "omitted (train one with --fn train_embedder)")
    pipe = _make_pipeline(cfg, device)
    cache = WindowCache(Path(cfg.data.cache_dir))
    results = evaluate_cache(pipe, cache, batch_size=min(cfg.gesture.batch_size, len(cache)),
                             seed=cfg.seed, smplx_model=smplx_model, embedder=embedder)
    print("[eval]", json.dumps(results, indent=1))
    if not cfg.debug:
        (run_dir / "eval_results.json").write_text(json.dumps(results, indent=1))


def task_train_embedder(cfg, device: torch.device):
    """Train the external FGD feature extractor on ground-truth windows only
    (never the generative model); writes ``<out_dir>/<ts>/embedder.npz``
    with its provenance, for ``data.embedder_path``."""
    import numpy as np

    from amuse_tpu_torch.core import motion as motion_mod
    from amuse_tpu_torch.data.cache import WindowCache
    from amuse_tpu_torch.eval import embedder as emb

    run_dir = _setup(cfg)
    cache = WindowCache(Path(cfg.data.cache_dir))
    if len(cache) == 0:
        raise SystemExit("[embedder] empty window cache - run prepare_data first")
    e = cfg.embedder
    ecfg = emb.EmbedderConfig(in_dim=motion_mod.FEATS_6D, window=cfg.data.window_frames,
                              channels=tuple(e.channels), latent_dim=e.latent_dim)
    model = emb.make_model(emb.init_params(cfg.seed, ecfg), ecfg, device)
    step, _ = emb.make_train_step(model, e.learning_rate)
    bsz = max(1, min(e.batch_size, len(cache)))
    n_batches = len(cache) // bsz
    order = np.arange(n_batches * bsz)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(e.epochs):
        t0 = time.time()
        rng.shuffle(order)
        tot = torch.zeros((), device=device)
        for b in range(n_batches):
            idx = order[b * bsz:(b + 1) * bsz]
            motion = torch.as_tensor(np.stack([cache[int(i)]["motion"] for i in idx]))
            tot += step(motion_mod.axis_angle_to_feats6d(motion.to(device)))
        if epoch % 10 == 0 or epoch == e.epochs - 1:
            print(f"[embedder] epoch {epoch + 1}/{e.epochs} "
                  f"({time.time() - t0:.1f}s): recon={tot.item() / max(n_batches, 1):.6f}")
    provenance = (f"trained by --fn train_embedder on cache={cfg.data.cache_dir} "
                  f"({len(cache)} windows), {e.epochs} epochs, seed {cfg.seed}")
    out = run_dir / "embedder.npz"
    emb.save(out, emb.params_of(model), ecfg, provenance)
    print(f"[embedder] saved -> {out}")


def task_infer_gesture(cfg, wav_dir: str = "viz_dump/test/speech", device: str = "cuda"):
    """Custom WAV -> SMPL-X npz per 10 s window."""
    from amuse_tpu_torch.audio.fbank import CHUNK_SAMPLES
    from amuse_tpu_torch.audio.wavio import load_wav_resampled
    from amuse_tpu_torch.data.actors import NAME_TO_GENDER
    from amuse_tpu_torch.viz.export import export_windows

    run_dir = _setup(cfg)
    pipe = _make_pipeline(cfg, device)
    wavs = sorted(Path(wav_dir).glob("*.wav"))
    if not wavs:
        print(f"[infer] no .wav files found under {wav_dir}")
        return
    reps = max(1, cfg.test.replication_times)
    for wav in wavs:
        try:
            wave = load_wav_resampled(wav)
        except (OSError, ValueError) as e:  # unreadable/corrupt file: skip, don't abort
            print(f"[infer] {wav.name}: unreadable ({e}); skipped")
            continue
        if wave.shape[-1] < CHUNK_SAMPLES:
            print(f"[infer] {wav.name}: shorter than one 10 s window; skipped")
            continue
        # BEAT-style stems carry the actor name (e.g. 2_scott_0_9_9)
        subject = next((p for p in wav.stem.split("_") if p in NAME_TO_GENDER), "")
        for rep in range(reps):
            # fold the wav identity into the seed (crc32: stable across processes)
            wav_seed = (cfg.seed + rep) * 1_000_003 + (zlib.crc32(wav.stem.encode()) & 0xFFFF)
            result = pipe.infer_wav(wave, seed=wav_seed)
            rep_dir = run_dir / "gesture" / wav.stem / f"rep{rep}"
            paths = export_windows(rep_dir, result, subject=subject, stem=wav.stem)
        print(f"[infer] {wav.name}: {len(paths)} windows x {reps} reps -> "
              f"{run_dir / 'gesture' / wav.stem}")


def main(argv=None):
    from amuse_tpu_torch.cli.config import load_config, parse_cli_overrides
    from amuse_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(prog="amuse-tpu-torch")
    p.add_argument("--fn", required=True, help=f"task, one of {', '.join(TASK_NAMES)}")
    p.add_argument("--cfg", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[], help="override key=value")
    p.add_argument("--wav-dir", default="viz_dump/test/speech")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.fn not in TASK_NAMES:
        p.error(f"unknown --fn {args.fn!r}; tasks: {', '.join(TASK_NAMES)}")
    ported = {"edit_gesture": task_edit_gesture, "eval_gesture": task_eval_gesture,
              "infer_gesture": task_infer_gesture, "prepare_data": task_prepare_data,
              "train_audio": task_train_audio, "train_embedder": task_train_embedder,
              "train_gesture": task_train_gesture}
    if args.fn not in ported:
        raise SystemExit(f"--fn {args.fn}: not yet ported to amuse_tpu_torch "
                         f"({', '.join(ported)} are)")
    cfg = load_config(args.cfg, parse_cli_overrides(args.set))
    device = resolve_device(args.device)
    if args.fn == "infer_gesture":
        task_infer_gesture(cfg, args.wav_dir, device)
    else:
        ported[args.fn](cfg, device)


if __name__ == "__main__":
    main()
