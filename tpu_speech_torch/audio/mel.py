"""Mel filterbanks, windows and the HiFi-GAN-convention log-mel.

Port of ``tpu_speech/audio/mel.py:28-211``: the librosa-compatible slaney
mel scale and filterbank, the periodic Hann window, ``mel_spectrogram_np``,
the log-mel that Grad-TTS's data pipeline computes on host threads, and
``mel_spectrogram``, the same log-mel as a differentiable torch function on
the wav's device (HiFi-GAN training's input mel and both loss mels). The
filterbank and window are constants built once on the host (and once per
device for ``mel_spectrogram``); the SPIRAL featurizer's device work
(framing, FFT, mel product, log) lives in
``tpu_speech_torch/ops/fused_logmel.py``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F

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


@functools.lru_cache(maxsize=16)
def _mel_constants(sampling_rate, n_fft, num_mels, fmin, fmax, win_size, device):
    """(mel_w.T (n_fft//2 + 1, num_mels), the window zero-padded to n_fft)
    on ``device``, built once per configuration and device. Made outside
    inference mode so that they are ordinary tensors wherever they are used."""
    window = hann_window(win_size)
    if win_size < n_fft:  # centred, as stft_magnitude pads it (mel.py:131-133)
        lpad = (n_fft - win_size) // 2
        window = np.pad(window, (lpad, n_fft - win_size - lpad))
    mel_w = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    with torch.inference_mode(False), torch.no_grad():
        return (torch.tensor(mel_w.T, device=device).contiguous(),
                torch.tensor(window, device=device))


def mel_spectrogram(
    y: torch.Tensor,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> torch.Tensor:
    """Log-mel spectrogram, HiFi-GAN convention, differentiable: (..., N)
    wav -> (..., T, num_mels) float32 on the wav's device, T = N // hop. The counterpart of ``tpu_speech/audio/mel.py::
    mel_spectrogram:190`` (with ``stft_magnitude:117`` and
    ``frame_signal:85``): the wav in fp32, reflect-pad (n_fft - hop) / 2,
    frames without centering times the Hann window, ``torch.fft.rfft``,
    sqrt(re^2 + im^2 + 1e-9), the slaney mel product, log(clamp(., 1e-5)).
    The SPIRAL featurizer's fused kernel (K1) is another function: other
    padding, magnitude and log guard, and no backward."""
    mel_wt, window = _mel_constants(int(sampling_rate), int(n_fft), int(num_mels),
                                    float(fmin), float(fmax), int(win_size), y.device)
    lead = y.shape[:-1]
    y = y.float().reshape(-1, y.shape[-1])
    pad = (n_fft - hop_size) // 2
    y = F.pad(y, (pad, pad), mode="reflect")
    frames = y.unfold(-1, n_fft, hop_size) * window  # (B, T, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    mel = torch.matmul(mag, mel_wt)
    return torch.log(torch.clamp(mel, min=1e-5)).reshape(*lead, -1, num_mels)
