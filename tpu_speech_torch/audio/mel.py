"""Mel filterbanks, windows and the host log-mel (numpy, host side).

Port of ``tpu_speech/audio/mel.py:28-84, 147-175``: the librosa-compatible
slaney mel scale and filterbank, the periodic Hann window, and
``mel_spectrogram_np``, the HiFi-GAN-convention log-mel that Grad-TTS's data
pipeline computes on host threads. The filterbank and window are constants
built once on the host; the SPIRAL featurizer's device work (framing, FFT,
mel product, log) lives in ``tpu_speech_torch/ops/fused_logmel.py``.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    return np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq
    )


@functools.lru_cache(maxsize=16)
def _mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]  # (n_mels+2, n_freq)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    weights = weights.astype(np.float32)
    weights.flags.writeable = False  # shared by every caller of the cache
    return weights


def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2 + 1),
    float32, read-only."""
    return _mel_filterbank(sample_rate, n_fft, n_mels, float(fmin), float(fmax))


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def mel_spectrogram_np(
    y: np.ndarray,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """Host-side (numpy) log-mel, the HiFi-GAN convention
    (Grad-TTS/hifi-gan/meldataset.py:51-74): reflect-pad (n_fft - hop) / 2,
    frames without centering, |.| = sqrt(re^2 + im^2 + 1e-9), the slaney mel
    product, log(clamp(., 1e-5)). (N,) or (B, N) wav -> (..., T, num_mels)."""
    y = np.asarray(y, dtype=np.float32)
    mel_w = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    window = hann_window(win_size)
    pad = (n_fft - hop_size) // 2
    y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)], mode="reflect")
    n = y.shape[-1]
    num_frames = 1 + (n - n_fft) // hop_size
    idx = np.arange(num_frames)[:, None] * hop_size + np.arange(n_fft)[None, :]
    frames = y[..., idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-9).astype(np.float32)
    mel = mag @ mel_w.T
    return np.log(np.clip(mel, 1e-5, None))
