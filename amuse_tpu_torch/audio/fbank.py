"""Kaldi-compatible log-mel filterbank front-end on torch tensors.

Port of ``amuse_tpu/audio/fbank.py``; the same semantics as the reference's

    torchaudio.compliance.kaldi.fbank(
        wave, htk_compat=True, sample_frequency=16000, use_energy=False,
        window_type='hanning', num_mel_bins=128, dither=0.0, frame_shift=10)

then zero-padding/cropping to 1024 frames and the dataset normalisation
``(x - mean) / (2 * std)``: 400-sample frames every 160 samples with
snip_edges framing, per-frame DC removal, pre-emphasis 0.97 (first sample
against itself), symmetric Hann window, zero-pad to 512, power spectrum,
Kaldi triangular HTK-mel bank on the first 256 bins, log floored at the
float32 epsilon. ``torch.fft.rfft`` stands where JAX uses XLA's rfft.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
CHUNK_SAMPLES = 160_000  # 10 s
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
PADDED_WINDOW = 512  # next power of two
NUM_MEL_BINS = 128
TARGET_FRAMES = 1024
PREEMPHASIS = 0.97
LOG_EPS = 1.1920928955078125e-07  # float32 machine eps, Kaldi's log floor

# Recorded BEAT training-set statistics.
DATASET_MEAN = -9.173025
DATASET_STD = 5.062332


def _mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def _mel_bank_np(
    num_bins: int = NUM_MEL_BINS,
    padded_window: int = PADDED_WINDOW,
    sample_rate: int = SAMPLE_RATE,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi triangular mel filterbank, shape (padded_window//2 + 1, num_bins).

    Built in float64; the extra Nyquist row is zero so one (257, 128) matmul
    applies the bank. Callers must not mutate the cached array.
    """
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    n_fft_bins = padded_window // 2
    fft_bin_width = sample_rate / padded_window
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    mel_freqs = _mel(fft_bin_width * np.arange(n_fft_bins, dtype=np.float64)[None, :])
    up = (mel_freqs - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel_freqs) / (right_mel - center_mel)
    bank = np.maximum(0.0, np.minimum(up, down))  # (num_bins, 256)

    full = np.zeros((n_fft_bins + 1, num_bins), dtype=np.float32)
    full[:n_fft_bins, :] = bank.T.astype(np.float32)
    return full


@functools.lru_cache(maxsize=2)
def _hann_np(length: int = FRAME_LENGTH) -> np.ndarray:
    # Symmetric Hann (torch.hann_window(periodic=False)).
    i = np.arange(length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (length - 1))).astype(np.float32)


def frame_signal(waveform: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., n_frames, FRAME_LENGTH) with snip_edges framing."""
    return waveform.unfold(-1, FRAME_LENGTH, FRAME_SHIFT)


def fbank(waveform: torch.Tensor, num_mel_bins: int = NUM_MEL_BINS) -> torch.Tensor:
    """Kaldi log-mel fbank of a mono waveform (..., N) -> (..., n_frames, bins)."""
    frames = frame_signal(waveform.to(torch.float32))
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove_dc_offset
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * prev
    frames = frames * torch.from_numpy(_hann_np()).to(frames.device)
    frames = F.pad(frames, (0, PADDED_WINDOW - FRAME_LENGTH))
    spectrum = torch.fft.rfft(frames, dim=-1).abs() ** 2  # (..., T, 257)
    bank = torch.from_numpy(_mel_bank_np(num_bins=num_mel_bins)).to(frames.device)
    return torch.log(torch.clamp(spectrum @ bank, min=LOG_EPS))


def pad_or_crop(fb: torch.Tensor, target_frames: int = TARGET_FRAMES) -> torch.Tensor:
    """Zero-pad (below) or crop the time axis to ``target_frames`` frames."""
    t = fb.shape[-2]
    if t < target_frames:
        return F.pad(fb, (0, 0, 0, target_frames - t))
    return fb[..., :target_frames, :]


def normalize(fb: torch.Tensor, mean: float = DATASET_MEAN, std: float = DATASET_STD) -> torch.Tensor:
    """Dataset normalisation (x - mean) / (2 * std)."""
    return (fb - mean) / (2.0 * std)


def wav_chunk_to_fbank(chunk: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """One 10 s mean-subtracted chunk (..., 160000) -> (..., 1024, 128) fbank.

    160000 samples give 998 frames, zero-padded to 1024.
    """
    fb = pad_or_crop(fbank(chunk))
    return normalize(fb) if normalized else fb


def window_waveform(waveform: np.ndarray, reference_quirk: bool = False) -> np.ndarray:
    """Full-length mono waveform -> (n_chunks, 160000) of 10 s chunks.

    Mean-subtracts the whole file once, then slices floor(N / 160000)
    chunks. ``reference_quirk=True`` reproduces the reference's loop-index
    start samples (chunk k starts at sample k, overlapping chunk 0).
    """
    wave = np.asarray(waveform, np.float32)
    if wave.ndim == 2:  # (channels, N) -> first channel, like kaldi fbank
        wave = wave[0]
    wave = wave - wave.mean()
    n_chunks = wave.shape[0] // CHUNK_SAMPLES
    if n_chunks == 0:
        raise ValueError(f"waveform too short: {wave.shape[0]} samples < {CHUNK_SAMPLES}")
    if reference_quirk:
        return np.stack([wave[k : k + CHUNK_SAMPLES] for k in range(n_chunks)])
    return wave[: n_chunks * CHUNK_SAMPLES].reshape(n_chunks, CHUNK_SAMPLES)
