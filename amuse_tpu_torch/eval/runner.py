"""Quantitative evaluation runner: FGD, diversity, APE/AVE, beat alignment,
R-precision over a stage-2 window cache.

Port of ``amuse_tpu/eval/runner.py``. Per batch of cached windows, on the
pipeline's device: the prior's posterior mean of the real motion (the real
features), one DDIM sampling of the same audio conditioning (kernel K3 on
the card: one launch per batch, the tail batch included), its decode, the
external embedder on both sides, SMPL-X FK joints (position space) or the
axis-angle rotations (rotation space), APE/AVE, and per window the audio
beats (fbank on the device, peak picking on the host) against the motion
beats of the generated and of the real motion. After the loop: FGD in the
prior's latent space and in the embedder's, diversity, and the 4-fold
cross-fit probe with R-precision when there are at least 8 windows.

The initial DDIM latents of a batch come from a CPU generator seeded by
(``seed``, the batch's first window), so the card and the CPU evaluate the
same draws; ``initial_latents`` injects them instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from amuse_tpu_torch.audio import fbank as fbank_mod
from amuse_tpu_torch.core import motion as motion_mod
from amuse_tpu_torch.core import smplx as smplx_mod
from amuse_tpu_torch.core.rotations import axis_angle_to_rotation_6d
from amuse_tpu_torch.data.cache import betas_for_actor_ids
from amuse_tpu_torch.eval import embedder as emb_mod
from amuse_tpu_torch.eval import metrics as M

PROBE_LABEL = ("linear ridge, audio(768)->prior latent(128), 4-fold cross-fit "
               "on these GT pairs (out-of-fold predictions)")


def make_fk(smplx_model: smplx_mod.SmplxModel):
    """(B, T, 55, 3) axis-angle + (B, T, 3) + (B, nb) betas -> (B, T, J, 3)
    joints, without vertices; the poses are sliced to the rig's joint count
    (unit-test rigs have fewer than 55)."""

    def fk(poses_aa: torch.Tensor, trans: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
        b, t = poses_aa.shape[:2]
        nj = smplx_model.num_joints
        poses = poses_aa.reshape(b, t, -1, 3)[:, :, :nj].reshape(b * t, nj * 3)
        nb = min(betas.shape[-1], smplx_model.shapedirs.shape[-1])
        bet = torch.repeat_interleave(betas[:, :nb], t, dim=0)
        out = smplx_mod.forward_batch(smplx_model, poses, bet, trans.reshape(b * t, 3),
                                      return_vertices=False)
        return out["joints"].reshape(b, t, -1, 3)

    return fk


def batch_latents(seed: int, start: int, shape: tuple) -> torch.Tensor:
    """The initial DDIM latents of the batch starting at window ``start``,
    from a CPU generator of its own per (seed, start)."""
    g = torch.Generator().manual_seed(seed * 1_000_003 + start)
    return torch.randn(shape, generator=g)


def audio_beats(waves: np.ndarray, device: torch.device) -> list[np.ndarray]:
    """Onset times of each (N, samples) waveform: one batched fbank on
    ``device``, the peak picking per window on the host."""
    mel = fbank_mod.fbank(torch.as_tensor(waves, dtype=torch.float32).to(device)).cpu().numpy()
    return [M.audio_beats_from_mel(m) for m in mel]


@torch.inference_mode()
def evaluate_cache(
    pipe,
    cache,
    max_windows: int = 256,
    batch_size: int = 32,
    seed: int = 0,
    smplx_model: Optional[smplx_mod.SmplxModel] = None,
    embedder: Optional[tuple] = None,  # (params, EmbedderConfig, provenance) of embedder.load
    initial_latents: Optional[torch.Tensor] = None,  # (n, latent_tokens, latent_dim)
) -> dict:
    """-> {fgd, fgd_embedder, diversity_real, diversity_gen, ape, ave, ...},
    the JAX package's keys and labels. ``smplx_model`` lies on the
    pipeline's device."""
    n = min(len(cache), max_windows)
    if n == 0:
        return {"num_windows": 0.0, "error": "empty window cache"}
    device = pipe.device
    # smaller caches than one batch still evaluate (smoke-test trees)
    batch_size = max(1, min(batch_size, n))
    real_feats, gen_feats, cond_feats = [], [], []
    real_emb, gen_emb = [], []
    ape_vals, ave_vals, beat_scores, beat_scores_real = [], [], [], []
    fk = make_fk(smplx_model) if smplx_model is not None else None
    emb_model = None
    if embedder is not None:
        emb_model = emb_mod.make_model(embedder[0], embedder[1], device).eval()
    latent_shape = (pipe.denoiser_cfg.latent_tokens, pipe.denoiser_cfg.latent_dim)

    for start in range(0, n, batch_size):
        # the tail is a smaller last batch: dropping it would leave up to
        # batch_size - 1 windows out of every metric
        items = [cache[i] for i in range(start, min(start + batch_size, n))]
        b = len(items)

        def stacked(field: str) -> torch.Tensor:
            return torch.as_tensor(np.stack([it[field] for it in items])).to(device)

        motion, con, emo, sty = (stacked(f) for f in ("motion", "con", "emo", "sty"))
        # the metrics and the embedder work in 6D + trans; the prior encodes
        # the representation it was trained on (motion_feats)
        m6 = motion_mod.axis_angle_to_feats6d(motion)
        # the posterior mean, not a sample: encoder noise would inflate the
        # real side's covariance and give even a perfect generator an FGD
        z_real = pipe.encode_motion_mu(pipe.motion_feats(motion))
        real_feats.append(z_real[:, 0])
        cond_feats.append(torch.cat([con, emo, sty], dim=-1))

        x0 = (batch_latents(seed, start, (b, *latent_shape)) if initial_latents is None
              else initial_latents[start:start + b])
        latents = pipe.generate_latents(con, emo, sty, initial_latents=x0)
        gen_feats.append(latents[:, 0])

        gen_aa, gen_tr = pipe.decode_motion(latents)
        ref_aa, ref_tr = motion_mod.feats6d_to_axis_angle(m6)
        if emb_model is not None:
            g6 = axis_angle_to_rotation_6d(gen_aa).reshape(b, gen_aa.shape[1], -1)
            real_emb.append(emb_mod.embed(emb_model, m6))
            gen_emb.append(emb_mod.embed(emb_model, torch.cat([g6, gen_tr], dim=-1)))
        if fk is not None:
            actors = np.stack([it["actor_id"] for it in items])
            betas = torch.from_numpy(betas_for_actor_ids(actors)).to(device)
            betas = betas[:, :smplx_model.shapedirs.shape[-1]]
            ref_sig, gen_sig = fk(ref_aa, ref_tr, betas), fk(gen_aa, gen_tr, betas)
        else:
            ref_sig, gen_sig = ref_aa, gen_aa
        ape_vals.append(float(M.ape(ref_sig, gen_sig)))
        ave_vals.append(float(M.ave(ref_sig, gen_sig)))

        with_audio = [i for i, it in enumerate(items) if "audio" in it]
        if with_audio:
            beats = audio_beats(np.stack([items[i]["audio"] for i in with_audio]), device)
            gen_np, ref_np = gen_sig.cpu().numpy(), ref_sig.cpu().numpy()
            for i, ab in zip(with_audio, beats):
                beat_scores.append(M.beat_alignment(M.motion_beats_from_joints(gen_np[i]), ab))
                # the calibration: what REAL motion scores on the same audio
                # with the same detectors
                beat_scores_real.append(
                    M.beat_alignment(M.motion_beats_from_joints(ref_np[i]), ab))

    real, gen = torch.cat(real_feats), torch.cat(gen_feats)
    out = {
        "fgd": float(M.fgd(real, gen)),
        "diversity_real": float(M.diversity(real, seed=seed)),
        "diversity_gen": float(M.diversity(gen, seed=seed)),
        "ape": float(np.mean(ape_vals)),
        "ave": float(np.mean(ave_vals)),
        "num_windows": float(real.shape[0]),
        "metric_space": "position" if smplx_model is not None else "rotation",
    }
    if beat_scores:
        out["beat_align_gen"] = float(np.mean(beat_scores))
        out["beat_align_real"] = float(np.mean(beat_scores_real))
    if emb_model is not None:
        out["fgd_embedder"] = float(M.fgd(torch.cat(real_emb), torch.cat(gen_emb)))
        out["fgd_embedder_provenance"] = embedder[2]

    # TM2T retrieval metrics in the joint space of a ridge probe from the
    # audio conditioning (con|emo|sty) onto the prior latent, cross-fit on
    # the ground-truth pairs of this eval set; r_size 32 when enough
    # windows exist, else n (labelled)
    n_pairs = int(real.shape[0])
    if n_pairs >= 8:
        cond_emb = M.cross_fit_linear_probe(torch.cat(cond_feats), real, seed=seed)
        r_size = min(32, n_pairs)
        for tag, feats in (("real", real), ("gen", gen)):
            suite = M.r_precision_suite(cond_emb, feats, r_size=r_size, seed=seed)
            out[f"matching_score_{tag}"] = suite["matching_score"]
            for k in (1, 2, 3):
                out[f"r_precision_top_{k}_{tag}"] = suite[f"r_precision_top_{k}"]
        out["r_precision_r_size"] = float(r_size)
        out["r_precision_probe"] = PROBE_LABEL
    return out
