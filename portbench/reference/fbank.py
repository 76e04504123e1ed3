"""Plain Kaldi log-mel filterbank and 10 s windowing, float32.

The reference's front end: ``torchaudio.compliance.kaldi.fbank(wave,
htk_compat=True, sample_frequency=16000, use_energy=False,
window_type='hanning', num_mel_bins=128, dither=0.0, frame_shift=10)``,
zero-padded to 1024 frames and normalised by the BEAT training set's
statistics as ``(x - mean) / (2 * std)``. 400-sample frames every 160
samples (snip edges), per-frame DC removal, pre-emphasis 0.97 with the
first sample against itself, a symmetric Hann window, zero padding to 512,
the power spectrum, and Kaldi's triangular HTK-mel bank over the first 256
bins; the log is floored at float32's epsilon.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16_000
WINDOW_SAMPLES = 160_000
FRAME_LENGTH = 400
FRAME_SHIFT = 160
PADDED = 512
MEL_BINS = 128
FRAMES = 1024
PREEMPHASIS = 0.97
LOG_FLOOR = float(np.finfo(np.float32).eps)
BEAT_MEAN = -9.173025
BEAT_STD = 5.062332


def mel_bank(bins: int = MEL_BINS, low_hz: float = 20.0) -> np.ndarray:
    """(PADDED // 2 + 1, bins) float32 Kaldi triangles; the Nyquist row is 0."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    lo, hi = mel(low_hz), mel(SAMPLE_RATE / 2.0)
    step = (hi - lo) / (bins + 1)
    left = lo + np.arange(bins, dtype=np.float64)[:, None] * step
    centre, right = left + step, left + 2 * step
    f = mel(SAMPLE_RATE / PADDED * np.arange(PADDED // 2, dtype=np.float64))[None, :]
    tri = np.maximum(0.0, np.minimum((f - left) / (centre - left), (right - f) / (right - centre)))
    out = np.zeros((PADDED // 2 + 1, bins), np.float32)
    out[:PADDED // 2] = tri.T
    return out


def hann() -> np.ndarray:
    i = np.arange(FRAME_LENGTH, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (FRAME_LENGTH - 1))).astype(np.float32)


def fbank(chunks: torch.Tensor) -> torch.Tensor:
    """(N, 160000) float32 windows -> (N, 1024, 128) normalised fbanks."""
    frames = chunks.float().unfold(-1, FRAME_LENGTH, FRAME_SHIFT)
    frames = frames - frames.mean(-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], -1)
    frames = (frames - PREEMPHASIS * prev) * torch.from_numpy(hann()).to(frames.device)
    frames = torch.nn.functional.pad(frames, (0, PADDED - FRAME_LENGTH))
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    logmel = torch.log(torch.clamp(power @ torch.from_numpy(mel_bank()).to(frames.device),
                                   min=LOG_FLOOR))
    logmel = torch.nn.functional.pad(logmel, (0, 0, 0, FRAMES - logmel.shape[-2]))
    return (logmel - BEAT_MEAN) / (2.0 * BEAT_STD)


def windows(waveform: np.ndarray) -> np.ndarray:
    """A whole mono clip -> (floor(n / 160000), 160000) windows of the clip
    with its mean removed once over the whole clip."""
    wave = np.asarray(waveform, np.float32)
    wave = wave - wave.mean()
    n = wave.shape[0] // WINDOW_SAMPLES
    if n == 0:
        raise ValueError(f"clip of {wave.shape[0]} samples is shorter than one window")
    return wave[: n * WINDOW_SAMPLES].reshape(n, WINDOW_SAMPLES)
