"""Quantitative gesture metrics: FGD, beat alignment, diversity, APE/AVE,
linear probes and R-precision.

Port of ``amuse_tpu/eval/metrics.py``. The tensor metrics run on the
device of their inputs (the eigensolvers of FGD on the card through
cuSOLVER); the beat detectors are numpy on the host, over the port's own
Kaldi fbank, which runs where its waveform lies.

  * FGD (Frechet Gesture Distance): Frechet distance between Gaussians fit
    to (N, D) feature embeddings of real and generated motion.
  * Beat alignment (Li et al. 2021): mean over motion beats of
    exp(-min_dist_to_audio_beat^2 / 2 sigma^2), with motion beats = local
    minima of joint speed and audio beats = spectral-flux onset peaks.
  * Diversity: mean L2 between random distinct pairs of features.
  * APE / AVE: average position error / variance error per joint.
  * R-precision and matching score (TM2T), in the joint space of a ridge
    probe from the audio conditioning onto the motion features.

Random draws do not match across frameworks, so the ones that decide a
value can be injected: ``diversity`` takes its pairs, and its default
pairs come from a CPU generator seeded by ``seed`` (the same pairs on the
card and the CPU). The probes' and R-precision's permutations are numpy's,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from amuse_tpu_torch.audio import fbank as fbank_mod

# ------------------------------------------------------------------ FGD


def gaussian_frechet_distance(mu1: torch.Tensor, cov1: torch.Tensor, mu2: torch.Tensor,
                              cov2: torch.Tensor) -> torch.Tensor:
    """FD^2 = |mu1-mu2|^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}).

    The matrix square root goes through C1^{1/2} C2 C1^{1/2} (symmetric
    PSD, the eigenvalues of C1 C2): ``eigh`` of C1, then ``eigvalsh`` of
    the product, in the inputs' dtype.
    """
    diff = torch.sum((mu1 - mu2) ** 2)
    e1, v1 = torch.linalg.eigh(cov1)
    sqrt_c1 = (v1 * torch.sqrt(torch.clamp(e1, min=0.0))) @ v1.T
    ei = torch.linalg.eigvalsh(sqrt_c1 @ cov2 @ sqrt_c1)
    tr_sqrt = torch.sum(torch.sqrt(torch.clamp(ei, min=0.0)))
    return diff + torch.trace(cov1) + torch.trace(cov2) - 2.0 * tr_sqrt


def _fit_gaussian(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mu = feats.mean(dim=0)
    x = feats - mu
    # n = 1: zero covariance (0/0 would be NaN); FGD degenerates to the mean
    # distance, the honest answer for a single sample
    return mu, (x.T @ x) / max(feats.shape[0] - 1, 1)


def fgd(real_feats: torch.Tensor, gen_feats: torch.Tensor) -> torch.Tensor:
    """Frechet distance between (N, D) real and (M, D) generated features."""
    mu_r, cov_r = _fit_gaussian(real_feats)
    mu_g, cov_g = _fit_gaussian(gen_feats)
    return gaussian_frechet_distance(mu_r, cov_r, mu_g, cov_g)


# --------------------------------------------------------- beat alignment
#
# Audio: librosa's onset pipeline (onset_strength spectral flux on the dB
# mel spectrogram, then util.peak_pick with onset_detect's 30 ms / 100 ms /
# delta=0.07 defaults) on the Kaldi front end's 10 ms hop. Motion: Li et al.
# 2021 (AIST++) kinematic beats, strict local minima of the summed
# per-joint speed within +-order frames.

_DB_PER_NAT = 10.0 / np.log(10.0)  # ln(power) -> decibels
FBANK_HOP_S = 0.01


def onset_envelope(log_mel: np.ndarray) -> np.ndarray:
    """(T, n_mels) ln-power mel -> (T-1,) envelope: the mean over bands of
    the positively rectified first difference of the dB spectrogram (lag
    1, no centering shift: frame t of the snip-edges framing sits at t*hop)."""
    s_db = np.asarray(log_mel, np.float64) * _DB_PER_NAT
    return np.maximum(np.diff(s_db, axis=0), 0.0).mean(axis=1)


def pick_peaks(x: np.ndarray, pre_max: int = 3, post_max: int = 1, pre_avg: int = 10,
               post_avg: int = 11, delta: float = 0.07, wait: int = 3) -> np.ndarray:
    """librosa.util.peak_pick: i is a peak iff x[i] is the max of
    x[i-pre_max : i+post_max], at least delta above the mean of
    x[i-pre_avg : i+post_avg], and more than wait samples after the
    previous peak (onset_detect's defaults at the 10 ms hop)."""
    x = np.asarray(x, np.float64)
    n = x.size
    if n == 0:
        return np.zeros(0, np.int64)
    peaks = []
    last = -np.inf
    for i in range(n):
        # the window max pads with 0.0 (mode="constant"), the window mean
        # replicates the edges (mode="nearest"), as librosa does
        w = x[max(i - pre_max, 0):min(i + post_max, n)]
        mov_max = w.max() if w.size else 0.0
        if w.size < pre_max + post_max:  # ran off an edge: the 0-padding joins
            mov_max = max(mov_max, 0.0)
        idx = np.clip(np.arange(i - pre_avg, i + post_avg), 0, n - 1)
        mov_avg = x[idx].mean()
        if x[i] == mov_max and x[i] >= mov_avg + delta and i > last + wait:
            peaks.append(i)
            last = i
    return np.asarray(peaks, np.int64)


def audio_beats_from_mel(log_mel: np.ndarray) -> np.ndarray:
    """Onset times (seconds) of one (T, n_mels) Kaldi mel: envelope[k]
    compares frames k+1 and k, so a peak at k is reported at (k+1) * hop,
    on the risen frame."""
    env = onset_envelope(log_mel)
    if env.size == 0:
        return np.zeros(0)
    return (pick_peaks(env) + 1) * FBANK_HOP_S


def audio_beats_from_waveform(waveform) -> np.ndarray:
    """Onset times (seconds) of a 16 kHz mono waveform (or the first row of
    a 2-D one), through the port's fbank on the waveform's device (numpy:
    the CPU)."""
    wave = torch.as_tensor(waveform, dtype=torch.float32)
    if wave.dim() == 2:
        wave = wave[0]
    return audio_beats_from_mel(fbank_mod.fbank(wave).cpu().numpy())


def motion_beats_from_joints(joints: np.ndarray, fps: float = 30.0) -> np.ndarray:
    """Kinematic beat times (seconds) of (T, J, 3) positions: strict local
    minima of the summed per-joint speed within +-order frames
    (argrelextrema(env, np.less, order=10) at 60 fps, scaled to ``fps``,
    neighbours clipped at the edges). A minimum at envelope index i is the
    pause at frame i+1."""
    j = np.asarray(joints, np.float64)
    if j.shape[0] < 3:
        return np.zeros(0)
    vel = np.linalg.norm(np.diff(j, axis=0), axis=-1)  # (T-1, J)
    env = vel.sum(axis=-1) if vel.ndim == 2 else vel
    order = max(1, round(10.0 * fps / 60.0))
    n = env.size
    idx = np.arange(n)
    keep = np.ones(n, bool)
    for shift in range(1, order + 1):
        keep &= env < env[np.clip(idx + shift, 0, n - 1)]
        keep &= env < env[np.clip(idx - shift, 0, n - 1)]
    return (np.flatnonzero(keep) + 1.0) / fps


def beat_alignment(motion_beats: np.ndarray, audio_beats: np.ndarray,
                   sigma: float = 0.1) -> float:
    """BeatAlign score: mean_m exp(-min_a (t_m - t_a)^2 / (2 sigma^2))."""
    if len(motion_beats) == 0 or len(audio_beats) == 0:
        return 0.0
    d = motion_beats[:, None] - audio_beats[None, :]
    min_d2 = np.min(d * d, axis=1)
    return float(np.mean(np.exp(-min_d2 / (2.0 * sigma * sigma))))


# --------------------------------------------------------------- diversity


def diversity_pairs(n: int, num_pairs: int = 200, seed: int = 0) -> tuple[torch.Tensor, ...]:
    """(i, j) index pairs with j != i (j is i plus a nonzero offset mod n),
    drawn from a CPU generator seeded by ``seed``."""
    g = torch.Generator().manual_seed(seed)
    i = torch.randint(0, n, (num_pairs,), generator=g)
    j = (i + torch.randint(1, n, (num_pairs,), generator=g)) % n
    return i, j


def diversity(feats: torch.Tensor, num_pairs: int = 200, seed: int = 0,
              pairs: Optional[tuple] = None) -> torch.Tensor:
    """Mean L2 between random distinct pairs of (N, D) features (TM2T
    convention); ``pairs`` = (i, j) index arrays in place of the draw."""
    n = feats.shape[0]
    if n < 2:
        return feats.new_zeros(())
    i, j = diversity_pairs(n, num_pairs, seed) if pairs is None else pairs
    i, j = (torch.as_tensor(a if torch.is_tensor(a) else np.array(a)).long().to(feats.device)
            for a in (i, j))
    return torch.linalg.norm(feats[i] - feats[j], dim=-1).mean()


# ---------------------------------------------------------------- APE/AVE


def ape(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Average Position Error: the mean per-joint L2 of (..., T, J, 3)."""
    return torch.linalg.norm(gt - pred, dim=-1).mean()


def ave(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Average Variance Error: |var_t(gt) - var_t(pred)| averaged."""
    return (gt.var(dim=-3, correction=0) - pred.var(dim=-3, correction=0)).abs().mean()


# ------------------------------------------- R-precision / matching score
#
# The TM2T retrieval metrics of the reference's val_metrics.py:277-316:
# shuffle the N matched (condition, motion) pairs, split them into groups
# of r_size (tail dropped), and inside each group rank every row's matched
# column among the euclidean distances. The joint space comes from a
# closed-form ridge probe from the audio conditioning onto the motion
# features, fit on ground-truth pairs only.


def euclidean_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, D) x (..., M, D) -> (..., N, M) distances by the reference's
    expansion |a|^2 - 2ab + |b|^2, clamped at zero before the sqrt."""
    d2 = ((a * a).sum(-1, keepdim=True) - 2.0 * (a @ b.transpose(-1, -2))
          + (b * b).sum(-1).unsqueeze(-2))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _with_ones(cond: torch.Tensor) -> torch.Tensor:
    return torch.cat([cond, cond.new_ones((cond.shape[0], 1))], dim=1)


def fit_linear_probe(cond: torch.Tensor, motion: torch.Tensor, l2: float = 1e-3) -> torch.Tensor:
    """Ridge map W (Dc+1, Dm) with [cond, 1] @ W ~= motion, in closed form;
    the small l2 keeps the normal equations well posed when N < Dc."""
    x = _with_ones(cond)
    gram = x.T @ x + l2 * torch.eye(x.shape[1], dtype=cond.dtype, device=cond.device)
    return torch.linalg.solve(gram, x.T @ motion)


def apply_linear_probe(w: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    return _with_ones(cond) @ w


def cross_fit_linear_probe(cond: torch.Tensor, motion: torch.Tensor, n_folds: int = 4,
                           l2: float = 1e-3, seed: int = 0) -> torch.Tensor:
    """Out-of-fold probe predictions (N, Dm) in ``motion``'s dtype: each
    row's prediction comes from a probe fit without it (folds: a numpy
    permutation of ``seed`` split f::n_folds), so that an in-sample fit that
    interpolates when N < D cannot pin the *_real suite at 1.0.

    The probes are fit and applied in float64. With fewer rows than
    conditioning dims (the eval's 100 windows of 768) the normal matrix's
    condition is ~|X|^2 / l2, and a float32 solve, as the JAX package runs
    it, moves the predictions by a third of their size between two solvers
    (XLA's and LAPACK's on one CPU, LAPACK's and cuSOLVER's), and with them
    the R-precision ranks."""
    n = int(cond.shape[0])
    n_folds = max(2, min(n_folds, n))
    perm = np.random.default_rng(seed).permutation(n)
    out_dtype, cond, motion = motion.dtype, cond.double(), motion.double()
    out = motion.new_zeros((n, motion.shape[1]))
    for f in range(n_folds):
        test_idx = perm[f::n_folds]
        train_mask = np.ones(n, dtype=bool)
        train_mask[test_idx] = False
        train = torch.from_numpy(np.flatnonzero(train_mask)).to(cond.device)
        test = torch.from_numpy(test_idx).to(cond.device)
        w = fit_linear_probe(cond[train], motion[train], l2=l2)
        out[test] = apply_linear_probe(w, cond[test])
    return out.to(out_dtype)


def r_precision_suite(cond_emb: torch.Tensor, motion_emb: torch.Tensor, r_size: int = 32,
                      top_k: int = 3, seed: int = 0) -> dict[str, float]:
    """-> {matching_score, r_precision_top_1..top_k, r_count} over (N, D)
    condition and motion embeddings whose row i match. Needs N >= r_size;
    the tail N % r_size pairs are dropped, as upstream."""
    n = int(cond_emb.shape[0])
    if n < r_size:
        raise ValueError(f"need at least r_size={r_size} pairs, got {n}")
    perm = np.random.default_rng(seed).permutation(n)  # upstream randperm
    n_groups = n // r_size
    keep = torch.from_numpy(perm[:n_groups * r_size]).to(cond_emb.device)
    c = cond_emb[keep].reshape(n_groups, r_size, -1)
    m = motion_emb[keep].reshape(n_groups, r_size, -1)
    dist = euclidean_distance_matrix(c, m)  # (G, R, R)
    d_match = torch.diagonal(dist, dim1=-2, dim2=-1)  # (G, R)
    offdiag = ~torch.eye(r_size, dtype=torch.bool, device=dist.device)
    # the matched column's rank: the columns strictly nearer plus half the
    # off-diagonal ties (a mode-collapsed generator, all distances equal,
    # then reads chance, as upstream's argsort over duplicates does)
    rank = ((dist < d_match[..., None]).sum(-1)
            + 0.5 * ((dist == d_match[..., None]) & offdiag).sum(-1))
    ks = torch.arange(1, top_k + 1, device=dist.device)
    topk = (rank.reshape(-1)[None, :] < ks[:, None]).sum(-1)  # (top_k,)
    r_count = n_groups * r_size
    out = {"matching_score": float(d_match.sum() / r_count), "r_count": float(r_count)}
    for k in range(top_k):
        out[f"r_precision_top_{k + 1}"] = float(topk[k] / r_count)
    return out
