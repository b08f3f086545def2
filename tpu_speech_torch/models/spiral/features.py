"""SPIRAL mel featurizer (NeMo FilterbankFeatures convention).

Port of ``tpu_speech/models/spiral/features.py:24-166``: time-domain peak
normalization over the whole padded row, train-only dither, preemphasis 0.97,
center=True STFT with a SYMMETRIC Hann window of win_length zero-padded to
n_fft, reflect centre pad, magnitude |X|^mag_power (the power spectrum by
default), slaney mel, log(x + 2^-24), normalization over the valid frames
(``per_feature``: each feature's mean and Bessel std + 1e-5;
``per_feature_causal``: the same over frames 0..t only, from running sums;
``all_features``: one mean and std over every feature of the row; anything
else: none), padded frames zeroed, output padded to a multiple of 16. Layout
(B, T, F).

The STFT -> log-mel core is ``ops/fused_logmel.py::fused_logmel``: the K1
kernel on CUDA, its plain unfold + rfft version on CPU, for every mag_power
(``mag_mode`` "power" at 2, "mag_eps" at 1, "pow" otherwise), where the JAX
package leaves its kernel for the rfft path at a power other than 1 or 2.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_speech_torch.audio.mel import mel_filterbank
from tpu_speech_torch.ops.fused_logmel import fused_logmel

CONSTANT = 1e-5


def hann_window_symmetric(win_length: int) -> np.ndarray:
    """torch.hann_window(periodic=False)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / (win_length - 1)))).astype(
        np.float32
    )


def _featurizer_constants(sample_rate: int, win_length: int, n_fft: int, nfilt: int,
                          lowfreq: float, highfreq: float, device: torch.device):
    window = hann_window_symmetric(win_length)
    lpad = (n_fft - win_length) // 2
    window = np.pad(window, (lpad, n_fft - win_length - lpad))
    fb = mel_filterbank(sample_rate, n_fft, nfilt, lowfreq, highfreq)
    with torch.inference_mode(False):  # a cached tensor outlives any inference region
        return torch.tensor(window, device=device), torch.tensor(fb, device=device)


@functools.lru_cache(maxsize=16)
def featurizer_constants(sample_rate: int, win_length: int, n_fft: int, nfilt: int,
                         lowfreq: float, highfreq: float, device: torch.device):
    """(window (n_fft,), mel filterbank (nfilt, n_fft//2 + 1)) float32 on
    ``device``, built and copied once per configuration and device: the
    center=True STFT's symmetric Hann of win_length zero-padded to n_fft, and
    the slaney filterbank. Shared by every call: read only."""
    return _featurizer_constants(sample_rate, win_length, n_fft, nfilt, lowfreq, highfreq,
                                 device)


def normalize_time_domain(x: torch.Tensor) -> torch.Tensor:
    peak = x.abs().amax(dim=1, keepdim=True)
    return x / (peak + 1e-5)


def stft_input(x: torch.Tensor, n_fft: int, preemph: Optional[float] = 0.97,
               do_normalize_time_domain: bool = True, dither: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The signal the STFT core reads: [peak-normalized], [dithered],
    preemphasized, reflect-padded by n_fft//2 on both sides (center=True)."""
    if do_normalize_time_domain:
        x = normalize_time_domain(x)
    if dither > 0:
        x = x + dither * torch.randn(x.shape, generator=generator,
                                     device=x.device, dtype=x.dtype)
    if preemph is not None:
        x = torch.cat([x[:, :1], x[:, 1:] - preemph * x[:, :-1]], dim=1)
    pad = n_fft // 2
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]


def filterbank_features(
    x: torch.Tensor,
    seq_len: torch.Tensor,
    sample_rate: int = 16000,
    window_size: float = 0.02,
    window_stride: float = 0.01,
    n_fft: Optional[int] = None,
    nfilt: int = 128,
    preemph: float = 0.97,
    lowfreq: float = 0.0,
    highfreq: Optional[float] = None,
    log_zero_guard_value: float = 2.0**-24,
    dither: float = CONSTANT,
    pad_to: int = 16,
    pad_value: float = 0.0,
    mag_power: float = 2.0,
    normalize: str = "per_feature",
    do_normalize_time_domain: bool = True,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """wav (B, N) float32, lengths (B,) -> (feats (B, T, nfilt), feat_lens (B,)).

    ``generator`` draws the dither noise when ``training`` (on x's device).
    """
    win_length = int(window_size * sample_rate)
    hop_length = int(window_stride * sample_rate)
    if n_fft is None:
        n_fft = 2 ** math.ceil(math.log2(win_length))
    highfreq = highfreq or sample_rate / 2

    feat_lens = torch.ceil(seq_len.to(torch.float32) / hop_length).to(torch.int32)
    if training and dither > 0 and generator is None:
        raise ValueError("training with dither needs a torch.Generator")
    xp = stft_input(x, n_fft, preemph, do_normalize_time_domain,
                    dither if training else 0.0, generator)

    # under torch.export the tables are built anew, as the graph's constants:
    # the cache must not keep the trace's stand-in tensors
    constants = _featurizer_constants if torch.compiler.is_exporting() else featurizer_constants
    window, fb = constants(sample_rate, win_length, n_fft, nfilt, lowfreq, highfreq, x.device)
    num_frames = 1 + (xp.shape[-1] - n_fft) // hop_length
    mag_mode = {2.0: "power", 1.0: "mag_eps"}.get(float(mag_power), "pow")
    feats = fused_logmel(
        xp, window, fb,
        n_fft=n_fft, hop_length=hop_length, num_frames=num_frames,
        mag_mode=mag_mode, mag_eps=0.0, mag_power=float(mag_power),
        log_mode="guard", log_guard=log_zero_guard_value,
    )

    t = feats.shape[1]
    valid = (torch.arange(t, device=x.device)[None, :] < feat_lens[:, None]).to(feats.dtype)
    vm = valid[:, :, None]
    if normalize == "per_feature":
        cnt = valid.sum(dim=1)[:, None]  # (B, 1)
        mean = (feats * vm).sum(dim=1) / cnt
        var = ((feats - mean[:, None, :]).square() * vm).sum(dim=1) / torch.clamp(
            cnt - 1.0, min=1.0)  # Bessel (torch.std default)
        std = torch.sqrt(var) + CONSTANT
        feats = (feats - mean[:, None, :]) / std[:, None, :]
    elif normalize == "per_feature_causal":
        # frame t by the statistics of frames 0..t only (running count, sum
        # and sum of squares), as the streaming featurizer carries them. The
        # variance s2 - n mean^2 cancels, so the sums and the variance run in
        # float64 (in float32 the first frames land up to ~5e-2 off the
        # float64 value, by an amount that depends on the summation order)
        f64, v64 = feats.double(), vm.double()
        cnt = torch.cumsum(v64, dim=1)
        s1 = torch.cumsum(f64 * v64, dim=1)
        s2 = torch.cumsum(f64.square() * v64, dim=1)
        mean = s1 / torch.clamp(cnt, min=1.0)
        var = (s2 - cnt * mean.square()) / torch.clamp(cnt - 1.0, min=1.0)
        std = torch.sqrt(torch.clamp(var, min=0.0)) + CONSTANT
        feats = ((f64 - mean) / std).to(feats.dtype)
    elif normalize == "all_features":
        cnt = valid.sum(dim=1)[:, None, None] * feats.shape[-1]
        mean = (feats * vm).sum(dim=(1, 2))[:, None, None] / cnt
        var = ((feats - mean).square() * vm).sum(dim=(1, 2))[:, None, None] / torch.clamp(
            cnt - 1.0, min=1.0)
        feats = (feats - mean) / (torch.sqrt(var) + CONSTANT)

    feats = feats * vm + pad_value * (1 - vm)
    if pad_to > 0 and t % pad_to != 0:
        feats = F.pad(feats, (0, 0, 0, pad_to - t % pad_to), value=pad_value)
    return feats, feat_lens
