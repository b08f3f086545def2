"""Fused wav -> log-mel: the Hopper kernel and its plain PyTorch version.

Port of ``tpu_speech/ops/fused_logmel.py`` (K1). ``fused_logmel`` launches
the hand-written CUDA kernel ``csrc/fused_logmel.cu`` on a CUDA tensor and
computes ``logmel_plain`` on a CPU tensor; a CUDA tensor it cannot take
raises. ``logmel_plain`` is the counterpart of ``logmel_reference:233``:
strided frames (``unfold``) -> window -> ``torch.fft.rfft`` -> power ->
mel -> log.

Semantics (both versions): ``x`` (B, N) float32 is already padded per the
caller's STFT convention; frame ``t`` reads ``x[:, t*hop : t*hop + n_fft]``
(zeros past the end of ``x``).
  mag_mode: 'power' -> re^2 + im^2; 'mag_eps' -> sqrt(re^2 + im^2 + mag_eps)
  log_mode: 'guard' -> log(mel + log_guard); 'clip' -> log(max(mel, log_guard))
Returns (B, num_frames, n_mels) float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu_speech_torch.ops import _build

__all__ = ["fused_logmel", "logmel_plain", "make_dft_mats"]

_MAG_MODES = {"power": 0, "mag_eps": 1}
_LOG_MODES = {"guard": 0, "clip": 1}
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_TF, _KC = 16, 16  # frames per block, DFT rows per stage (csrc/fused_logmel.cu)


def make_dft_mats(n_fft: int, window: torch.Tensor, mel_fb: torch.Tensor):
    """(dft (n_fft, 2*n_freq), mel (n_freq, n_mels)) on ``window.device``.

    ``dft = [cos*win | -sin*win]`` over the n_freq = n_fft//2 + 1 real bins
    only (the TPU version pads the bins to 384 for its tiles; this one does
    not). Angles are reduced exactly (k*n mod n_fft) and evaluated in float64
    before the cast, as the numpy ``make_dft_mats:54`` does.
    """
    n_freq = n_fft // 2 + 1
    dev = window.device
    n = torch.arange(n_fft, device=dev, dtype=torch.int64)
    k = torch.arange(n_freq, device=dev, dtype=torch.int64)
    ang = (2.0 * math.pi / n_fft) * torch.remainder(
        n[:, None] * k[None, :], n_fft
    ).to(torch.float64)
    win = window.to(torch.float64)[:, None]
    dft = torch.cat([torch.cos(ang) * win, -torch.sin(ang) * win], dim=1)
    mel = mel_fb.to(torch.float32).t().contiguous()
    return dft.to(torch.float32).contiguous(), mel


def logmel_plain(
    x: torch.Tensor,
    window: torch.Tensor,
    mel_fb: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    num_frames: int,
    mag_mode: str = "power",
    log_mode: str = "guard",
    log_guard: float = 2.0 ** -24,
    mag_eps: float = 1e-9,
) -> torch.Tensor:
    """Plain PyTorch log-mel (fp32, rfft path); ``window`` (n_fft,),
    ``mel_fb`` (n_mels, n_freq), both on ``x.device``."""
    need = (num_frames - 1) * hop_length + n_fft
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    frames = x[:, :need].unfold(1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1)
    mag2 = spec.real.square() + spec.imag.square()
    mel_in = torch.sqrt(mag2 + mag_eps) if mag_mode == "mag_eps" else mag2
    mel = mel_in @ mel_fb.t()
    if log_mode == "clip":
        return torch.log(torch.clamp(mel, min=log_guard))
    return torch.log(mel + log_guard)


def fused_logmel(
    x: torch.Tensor,
    window: torch.Tensor,
    mel_fb: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    num_frames: int,
    mag_mode: str = "power",
    log_mode: str = "guard",
    log_guard: float = 2.0 ** -24,
    mag_eps: float = 1e-9,
) -> torch.Tensor:
    """Fused wav -> log-mel; the kernel on CUDA, ``logmel_plain`` on CPU."""
    if mag_mode not in _MAG_MODES or log_mode not in _LOG_MODES:
        raise ValueError(f"unknown mode: mag_mode={mag_mode!r}, log_mode={log_mode!r}")
    if x.ndim != 2 or num_frames < 1:
        raise ValueError(f"x must be (B, N) with num_frames >= 1: {tuple(x.shape)}, {num_frames}")
    n_freq = n_fft // 2 + 1
    if window.shape != (n_fft,) or mel_fb.ndim != 2 or mel_fb.shape[1] != n_freq:
        raise ValueError(
            f"window {tuple(window.shape)} / mel_fb {tuple(mel_fb.shape)} do not "
            f"match n_fft={n_fft}"
        )
    kw = dict(n_fft=n_fft, hop_length=hop_length, num_frames=num_frames,
              mag_mode=mag_mode, log_mode=log_mode, log_guard=log_guard,
              mag_eps=mag_eps)
    if x.device.type == "cpu":
        return logmel_plain(x, window, mel_fb, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_logmel: unsupported device {x.device}")
    if x.dtype != torch.float32 or window.device != x.device or mel_fb.device != x.device:
        raise ValueError("fused_logmel: x, window and mel_fb must be float32 on one device")
    if hop_length % 4 or n_fft % _KC:
        raise ValueError(f"fused_logmel kernel needs hop % 4 == 0 and n_fft % {_KC} == 0 "
                         f"(hop={hop_length}, n_fft={n_fft})")
    span = (_TF - 1) * hop_length + n_fft + 3
    if 4 * (span + (2 * _KC + _TF) * n_freq) > _MAX_SMEM:
        raise ValueError(f"fused_logmel kernel: n_fft={n_fft}, hop={hop_length} "
                         "overflow shared memory")
    x = x.contiguous()
    dft, mel = make_dft_mats(n_fft, window, mel_fb)
    b, n = x.shape
    n_mels = mel.shape[1]
    out = torch.empty((b, num_frames, n_mels), device=x.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(x.device):  # the runtime launches on its current device
        err = lib.tsx_fused_logmel(
            x.data_ptr(), dft.data_ptr(), mel.data_ptr(), out.data_ptr(),
            b, n, n_fft, hop_length, n_freq, n_mels, num_frames,
            _MAG_MODES[mag_mode], mag_eps, _LOG_MODES[log_mode], log_guard,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "fused_logmel")
    _build.LAUNCHES["fused_logmel"] += 1
    return out
