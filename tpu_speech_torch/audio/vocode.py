"""Mel inversion: the mel pseudo-inverse and momentum ("fast") Griffin-Lim.

The port's counterpart of ``tpu_speech/audio/vocode.py:20-126`` (the
reference DiffVC/model/utils.py:42-110, ``PseudoInversion``,
``InitialReconstruction`` and ``FastGL``): the STFT is frames by ``unfold``
and ``torch.fft.rfft``, the inverse ``irfft`` and the same overlap-add (the
frames' hop-sized pieces added block by block, then divided by max(sum w^2,
1e-11), the centre trim), complex64 on the card. The window and the
pseudo-inverse are built once per configuration and device, so the 32
iterations copy nothing to the card and read nothing back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F

from tpu_speech_torch.audio.mel import hann_window, mel_filterbank


@functools.lru_cache(maxsize=None)
def mel_pseudo_inverse(sample_rate: int, n_fft: int, n_mels: int,
                       fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of the mel basis, (n_fft//2+1, n_mels)."""
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return np.linalg.pinv(basis).astype(np.float32)


@functools.lru_cache(maxsize=16)
def griffin_lim_constants(sample_rate: int, n_fft: int, n_mels: int, device: torch.device):
    """(the pseudo-inverse transposed (n_mels, n_fft//2+1), the periodic Hann
    window (n_fft,)) float32 on ``device``, built once. Shared: read only."""
    inv_t = np.ascontiguousarray(mel_pseudo_inverse(sample_rate, n_fft, n_mels).T)
    with torch.inference_mode(False):  # a cached tensor outlives any inference region
        return (torch.tensor(inv_t, device=device),
                torch.tensor(hann_window(n_fft), device=device))


def stft_complex(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    """Complex STFT with center=True reflect padding. (B, N) -> (B, T, F)."""
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames, dim=-1)


def istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT (center=True): overlap-add with window-square
    normalisation (torch.functional.istft semantics). spec (B, T, F) ->
    (B, hop (T - 1)) samples, or ``length``. n_fft must be a multiple of
    hop: the frames' hop-sized pieces are added block by block (the JAX
    package's scatter-add for other hops has no caller)."""
    if n_fft % hop:
        raise ValueError(f"n_fft {n_fft} is not a multiple of hop {hop}")
    b, t, _ = spec.shape
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # (B, T, n_fft)
    total = n_fft + hop * (t - 1)
    r = n_fft // hop  # overlapping frames per sample
    # piece p of frame i lands at output block i + p
    chunks = frames.reshape(b, t, r, hop)
    n_blocks = t + r - 1
    y = frames.new_zeros(b, n_blocks, hop)
    wsq = frames.new_zeros(n_blocks, hop)
    w2c = (window * window).reshape(r, hop)
    for p in range(r):
        y[:, p:p + t] += chunks[:, :, p]
        wsq[p:p + t] += w2c[p]
    y = y.reshape(b, n_blocks * hop)[:, :total]
    wsq = wsq.reshape(n_blocks * hop)[:total]
    y = y / torch.clamp(wsq, min=1e-11)
    pad = n_fft // 2
    y = y[:, pad:total - pad]
    if length is not None:
        y = y[:, :length]
    return y


def fast_griffin_lim(log_mel: torch.Tensor, n_mels: int = 80, sample_rate: int = 22050,
                     n_fft: int = 1024, hop: int = 256, n_iters: int = 32,
                     momentum: float = 0.99) -> torch.Tensor:
    """Log-mel (B, T, n_mels) -> waveform (B, hop (T - 1)) by momentum
    Griffin-Lim (FastGL, DiffVC/model/utils.py:78-110): pseudo-invert the
    mels to a magnitude STFT, start from zero phase, then iterate STFT /
    inverse STFT with momentum on the phase angles."""
    inv_t, window = griffin_lim_constants(sample_rate, n_fft, n_mels, log_mel.device)
    stftm = torch.exp(log_mel) @ inv_t  # (B, T, F) magnitude
    c = stftm.to(torch.complex64)
    x = istft(c, n_fft, hop, window)  # zero-phase start
    prev_angles = torch.zeros_like(c)
    for _ in range(n_iters):
        s = stft_complex(x, n_fft, hop, window)
        mag = torch.sqrt(torch.clamp(s.real ** 2 + s.imag ** 2, min=1e-8))
        angles = s / mag
        x = istft(c * (angles + momentum * (angles - prev_angles)), n_fft, hop, window)
        prev_angles = angles
    return x
