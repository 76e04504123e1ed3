"""WAV reading and writing with scipy (no torchaudio needed).

Reads 16 kHz mono PCM and normalises int PCM to float32 in [-1, 1] with the
scaling torchaudio uses; other rates are resampled polyphase.
"""

from __future__ import annotations

from math import gcd

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

EXPECTED_SR = 16_000


def load_wav(path, expected_sr: int | None = EXPECTED_SR) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 waveform in [-1, 1] shaped (channels, N), sr)."""
    sr, data = wavfile.read(path)
    if expected_sr is not None and sr != expected_sr:
        raise ValueError(f"sample rate is {sr}, expected {expected_sr}: {path}")
    if data.dtype == np.int16:
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 PCM
        wave = data.astype(np.float32)
    wave = wave[None, :] if wave.ndim == 1 else wave.T  # (channels, N)
    return wave, sr


def resample(wave: np.ndarray, orig_sr: int, target_sr: int = EXPECTED_SR) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_sr == target_sr:
        return np.asarray(wave, np.float32)
    g = gcd(orig_sr, target_sr)
    out = resample_poly(np.asarray(wave, np.float64), target_sr // g, orig_sr // g, axis=-1)
    return out.astype(np.float32)


def load_wav_resampled(path, target_sr: int = EXPECTED_SR) -> np.ndarray:
    """Read any-rate WAV -> float32 (channels, N) at ``target_sr``."""
    wave, sr = load_wav(path, expected_sr=None)
    return resample(wave, sr, target_sr)


def save_wav(path, wave: np.ndarray, sr: int = EXPECTED_SR) -> None:
    """Write float32 [-1, 1] (channels, N) or (N,) to 16-bit PCM."""
    wave = np.asarray(wave)
    if wave.ndim == 2:
        wave = wave.T
    pcm = np.clip(wave * 32768.0, -32768, 32767).astype(np.int16)
    wavfile.write(path, sr, pcm)
