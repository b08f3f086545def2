"""logMMSE speech denoiser: the port's own copy of ``tpu_speech/audio/logmmse.py``
(``profile_noise:34``, ``denoise:58``; numpy and scipy on the host, no
entry point calls it), which the port does not import. Reference capability:
DiffVC/speaker_encoder/utils/logmmse.py — the RTVC-vendored implementation of
the Ephraim–Malah (1985) log-spectral amplitude MMSE estimator with
decision-directed a-priori SNR and VAD-gated noise tracking).

Host-side utility (numpy): the spectral framing/FFT is vectorized over all
frames up front; only the decision-directed recursion (each frame's a-priori
SNR and the tracked noise spectrum depend on the previous frame's estimate)
runs as the unavoidable sequential loop over frames.

API matches the reference: ``profile_noise(noise, sr)`` -> profile,
``denoise(wav, profile, eta)`` -> cleaned wav of the same length.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class NoiseProfile:
    sampling_rate: int
    window_size: int
    len1: int  # hop (50% overlap)
    len2: int
    win: np.ndarray
    n_fft: int
    noise_mu2: np.ndarray  # tracked noise power spectrum


def profile_noise(noise: np.ndarray, sampling_rate: int,
                  window_size: int = 0) -> NoiseProfile:
    """Estimate a noise power spectrum from a noise-only waveform."""
    noise = np.asarray(noise, dtype=np.float64) + np.finfo(np.float64).eps
    if window_size == 0:
        window_size = int(math.floor(0.02 * sampling_rate))
    if window_size % 2 == 1:
        window_size += 1
    len1 = window_size // 2
    len2 = window_size - len1
    win = np.hanning(window_size)
    win = win * len2 / np.sum(win)
    n_fft = 2 * window_size

    n_frames = len(noise) // window_size
    if n_frames == 0:
        raise ValueError("noise clip shorter than one analysis window")
    frames = noise[: n_frames * window_size].reshape(n_frames, window_size)
    mags = np.abs(np.fft.fft(frames * win, n_fft, axis=1))
    noise_mu2 = (mags.mean(axis=0)) ** 2
    return NoiseProfile(sampling_rate, window_size, len1, len2, win, n_fft,
                        noise_mu2)


def denoise(wav: np.ndarray, profile: NoiseProfile,
            eta: float = 0.15) -> np.ndarray:
    """Clean `wav` given a noise profile of the same sampling rate.

    eta: VAD threshold below which the noise spectrum keeps adapting
    (0 freezes the profile).
    """
    from scipy.special import exp1

    p = profile
    x = np.asarray(wav, dtype=np.float64) + np.finfo(np.float64).eps
    n_frames = len(x) // p.len2 - p.window_size // p.len2
    if n_frames <= 0:
        return np.asarray(wav, dtype=np.float32)

    # all analysis frames + spectra in one shot (50% overlap)
    starts = np.arange(n_frames) * p.len2
    frames = np.stack([x[s:s + p.window_size] for s in starts])
    specs = np.fft.fft(frames * p.win, p.n_fft, axis=1)
    sig2_all = np.abs(specs) ** 2

    aa, mu = 0.98, 0.98  # decision-directed / noise-tracking smoothing
    ksi_min = 10 ** (-25 / 10)

    out = np.zeros(n_frames * p.len2)
    x_old = np.zeros(p.len1)
    xk_prev = None
    noise_mu2 = p.noise_mu2.copy()
    for i in range(n_frames):
        sig2 = sig2_all[i]
        gammak = np.minimum(sig2 / noise_mu2, 40)  # a-posteriori SNR
        if xk_prev is None:
            ksi = aa + (1 - aa) * np.maximum(gammak - 1, 0)
        else:
            ksi = aa * xk_prev / noise_mu2 + (1 - aa) * np.maximum(
                gammak - 1, 0
            )
            ksi = np.maximum(ksi_min, ksi)

        # likelihood-ratio VAD; adapt noise while speech is absent
        log_sigma_k = gammak * ksi / (1 + ksi) - np.log(1 + ksi)
        if np.sum(log_sigma_k) / p.window_size < eta:
            noise_mu2 = mu * noise_mu2 + (1 - mu) * sig2

        a = ksi / (1 + ksi)
        vk = np.maximum(a * gammak, 1e-8)
        hw = a * np.exp(0.5 * exp1(vk))  # log-MMSE gain
        xk_prev = (np.abs(specs[i]) * hw) ** 2
        xi_w = np.real(np.fft.ifft(hw * specs[i], p.n_fft))
        # overlap-add
        out[i * p.len2:(i + 1) * p.len2] = x_old + xi_w[: p.len1]
        x_old = xi_w[p.len1: p.window_size]

    out = np.pad(out, (0, len(x) - len(out)))
    return out.astype(np.float32)
