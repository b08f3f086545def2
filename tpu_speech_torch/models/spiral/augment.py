"""Spectrogram augmentations (SpecAugment, SpecCutout, crop-or-pad), the
negative cosine similarity loss, and MFCC.

Port of ``tpu_speech/models/spiral/augment.py``. Spec layout (B, T, F). Each
random function draws its starts, widths or offsets from a
``torch.Generator`` on the spectrogram's device (the ranges JAX's
``jax.random.randint`` draws from), then calls the function that applies
given ones (``apply_spec_augment``, ``apply_spec_cutout``,
``crop_or_pad_at``): the draws cannot equal JAX's, so a parity test redraws
JAX's values on the CPU and hands them to the inner function (ROADMAP
"Randomness").

``mfcc_features`` runs the featurizer without normalization
(``features.py::filterbank_features(normalize=None)``: K1 on the card) and
then an orthonormal DCT-II built in numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_speech_torch.models.spiral.features import filterbank_features


def _randint(generator, low: int, high: int, shape, device) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=generator, device=device)


def band_mask(size: int, starts: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """(B, n) band starts and widths -> (B, size) True inside any band."""
    pos = torch.arange(size, device=starts.device)[None, None, :]
    m = (pos >= starts[:, :, None]) & (pos < (starts + widths)[:, :, None])
    return m.any(dim=1)


def spec_augment_draws(generator: torch.Generator, shape, freq_masks: int = 2,
                       time_masks: int = 2, freq_width: int = 27, time_width: int = 100,
                       device=None):
    """(freq starts, freq widths, time starts, time widths), each (B, n)."""
    b, t, f = shape
    return (_randint(generator, 0, max(f - freq_width, 1), (b, freq_masks), device),
            _randint(generator, 0, freq_width + 1, (b, freq_masks), device),
            _randint(generator, 0, max(t - time_width, 1), (b, time_masks), device),
            _randint(generator, 0, time_width + 1, (b, time_masks), device))


def apply_spec_augment(specs: torch.Tensor, f_starts, f_widths, t_starts, t_widths,
                       mask_value: float = 0.0) -> torch.Tensor:
    """Frequency bands, then time bands, set to ``mask_value``."""
    out = specs
    if f_starts.shape[1] > 0:
        out = out.masked_fill(band_mask(specs.shape[2], f_starts, f_widths)[:, None, :],
                              mask_value)
    if t_starts.shape[1] > 0:
        out = out.masked_fill(band_mask(specs.shape[1], t_starts, t_widths)[:, :, None],
                              mask_value)
    return out


def spec_augment(generator: torch.Generator, specs: torch.Tensor, freq_masks: int = 2,
                 time_masks: int = 2, freq_width: int = 27, time_width: int = 100,
                 mask_value: float = 0.0) -> torch.Tensor:
    """SpecAugment: random frequency and time bands zeroed (fixed max widths,
    vectorized); ``generator`` lies on the specs' device."""
    draws = spec_augment_draws(generator, specs.shape, freq_masks, time_masks, freq_width,
                               time_width, specs.device)
    return apply_spec_augment(specs, *draws, mask_value=mask_value)


def apply_spec_cutout(specs: torch.Tensor, t_starts, f_starts, t_widths, f_widths,
                      mask_value: float = 0.0) -> torch.Tensor:
    """(B, R) rectangles [t, t + tw) x [f, f + fw) set to ``mask_value``."""
    b, t, f = specs.shape
    tpos = torch.arange(t, device=specs.device)[None, None, :]
    fpos = torch.arange(f, device=specs.device)[None, None, :]
    tm = (tpos >= t_starts[:, :, None]) & (tpos < (t_starts + t_widths)[:, :, None])
    fm = (fpos >= f_starts[:, :, None]) & (fpos < (f_starts + f_widths)[:, :, None])
    rect = (tm[:, :, :, None] & fm[:, :, None, :]).any(dim=1)  # (B, T, F)
    return specs.masked_fill(rect, mask_value)


def spec_cutout(generator: torch.Generator, specs: torch.Tensor, rect_masks: int = 5,
                rect_time: int = 25, rect_freq: int = 15,
                mask_value: float = 0.0) -> torch.Tensor:
    """SpecCutout: random time-frequency rectangles zeroed."""
    b, t, f = specs.shape
    dev = specs.device
    ts = _randint(generator, 0, max(t - rect_time, 1), (b, rect_masks), dev)
    fs = _randint(generator, 0, max(f - rect_freq, 1), (b, rect_masks), dev)
    tw = _randint(generator, 0, rect_time + 1, (b, rect_masks), dev)
    fw = _randint(generator, 0, rect_freq + 1, (b, rect_masks), dev)
    return apply_spec_cutout(specs, ts, fs, tw, fw, mask_value)


def crop_or_pad_at(specs: torch.Tensor, lengths: torch.Tensor, audio_length: int,
                   offsets: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop the time axis at ``offsets`` (B,) (the centre when None) or
    zero-pad it to exactly ``audio_length`` frames; lengths capped."""
    b, t, f = specs.shape
    if t <= audio_length:
        return torch.nn.functional.pad(specs, (0, 0, 0, audio_length - t)), lengths
    if offsets is None:
        offsets = torch.full((b,), (t - audio_length) // 2, device=specs.device)
    idx = offsets.to(specs.device).long()[:, None] + torch.arange(audio_length,
                                                                  device=specs.device)
    out = torch.gather(specs, 1, idx[:, :, None].expand(b, audio_length, f))
    return out, torch.clamp(lengths, max=audio_length)


def crop_or_pad_spectrogram(specs: torch.Tensor, lengths: torch.Tensor, audio_length: int,
                            generator: Optional[torch.Generator] = None):
    """Crop (random offsets if ``generator`` is given, else the centre) or
    zero-pad the time axis to exactly ``audio_length`` frames."""
    b, t, _ = specs.shape
    offsets = None
    if t > audio_length and generator is not None:
        offsets = _randint(generator, 0, t - audio_length + 1, (b,), specs.device)
    return crop_or_pad_at(specs, lengths, audio_length, offsets)


def negative_cosine_similarity_loss(preds, targets, valid_mask=None):
    """-cos(pred, target) averaged over the (valid) frames
    (losses/similarityloss.py:21-31)."""
    num = (preds * targets).sum(dim=-1)
    den = torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(targets, dim=-1)
    cos = num / torch.clamp(den, min=1e-8)
    if valid_mask is not None:
        return -(cos * valid_mask).sum() / torch.clamp(valid_mask.sum(), min=1.0)
    return -cos.mean()


def dct_matrix(n_mfcc: int, nfilt: int) -> np.ndarray:
    """(n_mfcc, nfilt) orthonormal DCT-II, float64."""
    n = np.arange(nfilt)
    k = np.arange(n_mfcc)[:, None]
    dct = np.cos(np.pi * k * (2 * n + 1) / (2 * nfilt)) * np.sqrt(2.0 / nfilt)
    dct[0] *= 1.0 / np.sqrt(2.0)
    return dct


def mfcc_features(x: torch.Tensor, seq_len: torch.Tensor, n_mfcc: int = 64,
                  **filterbank_kwargs):
    """MFCC preprocessor (AudioToMFCCPreprocessor): the DCT-II of the
    unnormalized log-mel features -> ((B, T, n_mfcc), lengths)."""
    feats, lens = filterbank_features(x, seq_len, normalize=None, **filterbank_kwargs)
    dct = dct_matrix(n_mfcc, feats.shape[-1])
    return feats @ torch.tensor(dct.T.astype(np.float32), device=feats.device), lens
