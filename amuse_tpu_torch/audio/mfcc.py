"""MFCC front end and DTW alignment on torch tensors.

Port of ``amuse_tpu/audio/mfcc.py`` (the reference's legacy audio path,
dm/utils/wav_utils.py audio2mfcc / audio2dtw): 13 MFCCs with the semantics
of ``torchaudio.transforms.MFCC`` under the reference's melkwargs (n_fft
2048, hop 128, 128 htk mels; centred reflect padding, periodic Hann, power
spectrogram, dB with a per-clip 80 dB floor below the peak, ortho DCT-II),
built here without torchaudio; and dynamic time warping between two MFCC
sequences.

Two differences from the JAX package: ``torch.fft.rfft`` stands where XLA's
FFT does and rounds differently; and ``dtw_cost`` runs the recursion over
anti-diagonals (every cell of one anti-diagonal at once, about Ta + Tb
steps) where JAX scans row by row and each row cell by cell. Each cell
takes the same addition of the same minimum, so on one cost matrix the two
agree bit for bit but for the first row, which this sums left to right and
JAX builds with ``jnp.cumsum`` in XLA's order; what the first row's rounding
moves is carried along the path.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 2048  # configs/base_new.json:42
HOP_LENGTH = 128  # :43 -> 125 MFCC frames per second
N_MELS = 128  # :44
TOP_DB = 80.0  # torchaudio AmplitudeToDB default used by T.MFCC


@functools.lru_cache(maxsize=4)
def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis (torchaudio create_dct norm='ortho'), (n_mels, n_mfcc)."""
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(n_mels)[None, :]
    basis = np.cos(math.pi / n_mels * (n + 0.5) * k) * math.sqrt(2.0 / n_mels)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return basis.astype(np.float32).T


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def _mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """(n_freqs, n_mels) triangles: torchaudio melscale_fbanks(htk, norm=None)."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    pts = _mel_to_hz_htk(
        np.linspace(_hz_to_mel_htk(0.0), _hz_to_mel_htk(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(pts)
    slopes = pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _frame_index(n: int, n_fft: int, hop_length: int, device) -> torch.Tensor:
    """(T, n_fft) sample indices of the centred frames into the unpadded
    signal, on ``device``: numpy's 'reflect' padding by n_fft // 2 at any
    length (the reflection repeats where the pad exceeds the signal)."""
    n_frames = n // hop_length + 1
    pos = (torch.arange(n_frames, device=device)[:, None] * hop_length
           + torch.arange(n_fft, device=device)[None, :] - n_fft // 2)
    if n == 1:
        return torch.zeros_like(pos)
    period = 2 * (n - 1)
    pos = torch.remainder(pos, period)
    return torch.where(pos >= n, period - pos, pos)


def mfcc(waveform: torch.Tensor, n_mfcc: int = 13, n_fft: int = N_FFT,
         hop_length: int = HOP_LENGTH, n_mels: int = N_MELS,
         sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """(..., N) float32 waveform -> (..., T, n_mfcc), T = N // hop + 1, on
    the waveform's device. Time-major (torchaudio returns (..., n_mfcc, T))."""
    dev = waveform.device
    frames = waveform[..., _frame_index(waveform.shape[-1], n_fft, hop_length, dev)]
    window = torch.from_numpy(
        0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))).to(dev, frames.dtype)
    spec = torch.abs(torch.fft.rfft(frames * window)) ** 2
    mel = spec @ torch.from_numpy(_mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate)).to(dev)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    # AmplitudeToDB's top_db floor per clip (over its own (T, n_mels) plane)
    db = torch.maximum(db, torch.amax(db, dim=(-2, -1), keepdim=True) - TOP_DB)
    return db @ torch.from_numpy(_dct_matrix(n_mfcc, n_mels)).to(dev)


def dtw_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Accumulated DTW cost matrix (Ta, Tb) between (Ta, D) and (Tb, D) sequences.

    acc[i, j] = cost[i, j] + min(acc[i-1, j], acc[i-1, j-1], acc[i, j-1])
    over the pairwise L2 cost, computed one anti-diagonal (i + j = k) at a
    time in a skewed buffer whose column 0 stands for i = -1 (infinite).
    """
    ta, tb = a.shape[0], b.shape[0]
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    d = torch.sqrt(torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=1e-12))
    inf = torch.tensor(float("inf"), device=a.device, dtype=d.dtype)
    n_diag = ta + tb - 1
    i = torch.arange(ta, device=a.device)
    j = torch.arange(n_diag, device=a.device)[:, None] - i[None, :]  # (K, Ta)
    valid = (j >= 0) & (j < tb)
    cost = torch.where(valid, d[i[None, :], j.clamp(0, tb - 1)], inf)  # cost[k, i] = d[i, k-i]
    skew = torch.full((n_diag, ta + 1), float("inf"), device=a.device, dtype=d.dtype)
    skew[0, 1] = cost[0, 0]
    for k in range(1, n_diag):
        up, left = skew[k - 1, :-1], skew[k - 1, 1:]
        diag = skew[k - 2, :-1] if k > 1 else up.new_full((ta,), float("inf"))
        torch.add(cost[k], torch.minimum(torch.minimum(up, diag), left), out=skew[k, 1:])
    return skew[i[:, None] + torch.arange(tb, device=a.device)[None, :], i[:, None] + 1]


def dtw_path(acc: np.ndarray) -> list[tuple[int, int]]:
    """Backtrack the warping path from an accumulated cost matrix (host)."""
    i, j = acc.shape[0] - 1, acc.shape[1] - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            moves = [(acc[i - 1, j - 1], i - 1, j - 1),
                     (acc[i - 1, j], i - 1, j),
                     (acc[i, j - 1], i, j - 1)]
            _, i, j = min(moves)
        path.append((i, j))
    return path[::-1]


def align_mfcc(wave_a: torch.Tensor, wave_b: torch.Tensor,
               n_mfcc: int = 13) -> tuple[float, list[tuple[int, int]]]:
    """Two waveforms -> (DTW distance over Ta + Tb, warping path): the
    reference's audio2dtw."""
    ma, mb = mfcc(wave_a, n_mfcc), mfcc(wave_b, n_mfcc)
    acc = dtw_cost(ma, mb).cpu().numpy()
    return float(acc[-1, -1]) / (ma.shape[0] + mb.shape[0]), dtw_path(acc)
