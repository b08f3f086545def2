"""Fused wav -> log-mel: the Hopper kernel and its plain PyTorch version.

Port of ``tpu_speech/ops/fused_logmel.py`` (K1). ``fused_logmel`` calls the
registered op ``tpu_speech::fused_logmel`` (``fused_logmel_op``), which
launches the hand-written CUDA kernel ``csrc/fused_logmel.cu`` on a CUDA
tensor and computes ``logmel_plain`` on a CPU tensor; ``torch.export``
keeps the op in its graph. The kernel's transform is a
float64 real FFT per frame for a power-of-two n_fft in ``KERNEL_N_FFT`` (the
SPIRAL and HiFi-GAN path) and a float64 direct DFT over a table of n_fft
twiddles for any other n_fft up to ``DFT_MAX_N_FFT``; any hop >= 1; then a
banded mel product. A CUDA tensor past those limits raises.
``logmel_plain`` is the counterpart of ``logmel_reference:233``: strided
frames (``unfold``) -> window -> ``torch.fft.rfft`` -> power -> mel -> log.

Semantics (both versions): ``x`` (B, N) float32 is already padded per the
caller's STFT convention; frame ``t`` reads ``x[:, t*hop : t*hop + n_fft]``
(zeros past the end of ``x``).
  mag_mode: 'power' -> re^2 + im^2; 'mag_eps' -> sqrt(re^2 + im^2 + mag_eps);
            'pow' -> |X|^mag_power (the JAX featurizer's rfft path, which it
            takes for a mag_power other than 1 or 2)
  log_mode: 'guard' -> log(mel + log_guard); 'clip' -> log(max(mel, log_guard))
Returns (B, num_frames, n_mels) float32.

The kernel's constant inputs are built once and cached: the twiddle tables
per (n_fft, device) (``fft_tables``, ``dft_table``) and each filterbank's nonzero bands per
filterbank tensor (``mel_bands``, on the device, no host sync). A call with
warm caches copies nothing to the card and does not synchronise.
"""

from __future__ import annotations

import functools
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from tpu_speech_torch.ops import _build

__all__ = ["fused_logmel", "fused_logmel_op", "logmel_plain", "make_dft_mats", "fft_tables",
           "dft_table", "mel_bands", "kernel_launch_config", "kernel_transform"]

_MAG_MODES = {"power": 0, "mag_eps": 1, "pow": 2}
_LOG_MODES = {"guard": 0, "clip": 1}
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
KERNEL_N_FFT = (128, 256, 512, 1024, 2048)  # the FFT's transform sizes
DFT_MAX_N_FFT = 8192  # the direct DFT's largest n_fft (csrc/fused_logmel.cu)


def make_dft_mats(n_fft: int, window: torch.Tensor, mel_fb: torch.Tensor):
    """(dft (n_fft, 2*n_freq), mel (n_freq, n_mels)) on ``window.device``.

    ``dft = [cos*win | -sin*win]`` over the n_freq = n_fft//2 + 1 real bins
    only (the TPU version pads the bins to 384 for its tiles; this one does
    not). Angles are reduced exactly (k*n mod n_fft) and evaluated in float64
    before the cast, as the numpy ``make_dft_mats:54`` does. The counterpart
    of the TPU kernel's operands; the Hopper kernel transforms by an FFT over
    ``fft_tables`` and reads no DFT matrix.
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
    mag_power: float = 2.0,
) -> torch.Tensor:
    """Plain PyTorch log-mel (fp32, rfft path); ``window`` (n_fft,),
    ``mel_fb`` (n_mels, n_freq), both on ``x.device``. ``mag_mode="pow"``
    takes |X| = sqrt(re^2 + im^2) to ``mag_power``, as the JAX rfft path
    does."""
    need = (num_frames - 1) * hop_length + n_fft
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    frames = x[:, :need].unfold(1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1)
    mag2 = spec.real.square() + spec.imag.square()
    if mag_mode == "mag_eps":
        mel_in = torch.sqrt(mag2 + mag_eps)
    elif mag_mode == "pow":
        mel_in = torch.sqrt(mag2) ** mag_power
    else:
        mel_in = mag2
    mel = mel_in @ mel_fb.t()
    if log_mode == "clip":
        return torch.log(torch.clamp(mel, min=log_guard))
    return torch.log(mel + log_guard)


def _bitrev(x: np.ndarray, bits: int) -> np.ndarray:
    r = np.zeros_like(x)
    for i in range(bits):
        r = (r << 1) | ((x >> i) & 1)
    return r


def twiddle_exponents(n_fft: int) -> np.ndarray:
    """The integer a of each entry W_N^a = exp(-2 pi i a / n_fft) of the
    kernel's table, in its order (``csrc/fused_logmel.cu``): with M = n_fft/2
    = 32 V complex points, lane l and register p,
      [p*32 + l]             W_M^(l * bitrev_V(p))    (after the V-point DFTs)
      [M + a*32 + l]         W_N^k, a < V/2, k = l//16 + 2 bitrev_(V/2)(a)
                             + V bitrev_16(l % 16)    (the real split)
      [3M/2 + e]             W_V^e, e < V/2           (the V-point DFTs)
      [3M/2 + V/2 + j]       W_32^j, j < 16           (the cross-lane DFTs)
    """
    m = n_fft // 2
    v = m // 32
    logv = v.bit_length() - 1
    p, lane = np.meshgrid(np.arange(v), np.arange(32), indexing="ij")
    a, lane2 = np.meshgrid(np.arange(v // 2), np.arange(32), indexing="ij")
    return np.concatenate([
        (2 * lane * _bitrev(p, logv)).ravel(),             # W_M^a = W_N^(2a)
        (lane2 // 16 + 2 * _bitrev(a, logv - 1) + v * _bitrev(lane2 % 16, 4)).ravel(),
        np.arange(v // 2) * (n_fft // v),
        np.arange(16) * (n_fft // 32),
    ]) % n_fft


@functools.lru_cache(maxsize=None)
def fft_tables(n_fft: int, device: torch.device) -> torch.Tensor:
    """The kernel's float64 twiddle table (entries, 2) = (cos, -sin) of
    2 pi a / n_fft for ``twiddle_exponents``, on ``device``; built once per
    (n_fft, device), with the angle reduced exactly (a mod n_fft) before
    the float64 cos and sin, as ``make_dft_mats`` does. Shared: read only."""
    ang = (2.0 * np.pi / n_fft) * twiddle_exponents(n_fft).astype(np.float64)
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    with torch.inference_mode(False):  # a cached tensor outlives any inference region
        return torch.from_numpy(tab).to(device)


@functools.lru_cache(maxsize=None)
def dft_table(n_fft: int, device: torch.device) -> torch.Tensor:
    """The direct DFT's float64 table (n_fft, 2) = (cos, -sin) of
    2 pi a / n_fft for a < n_fft, on ``device``: the kernel reads W_N^(kn)
    at a = kn mod n_fft. Built once per (n_fft, device). Shared: read only."""
    ang = (2.0 * np.pi / n_fft) * np.arange(n_fft, dtype=np.float64)
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    with torch.inference_mode(False):  # a cached tensor outlives any inference region
        return torch.from_numpy(tab).to(device)


# filterbank tensor id -> (weak reference, version, data pointer, bands)
_BANDS: dict = {}


def _bands(mel_fb: torch.Tensor) -> torch.Tensor:
    n_freq = mel_fb.shape[1]
    nz = mel_fb != 0
    idx = torch.arange(n_freq, device=mel_fb.device)
    hi = torch.where(nz, idx + 1, 0).amax(dim=1)
    lo = torch.minimum(torch.where(nz, idx, n_freq).amin(dim=1), hi)
    return torch.stack([lo, hi]).to(torch.int32).contiguous()


def mel_bands(mel_fb: torch.Tensor) -> torch.Tensor:
    """int32 (2, n_mels) on ``mel_fb``'s device: row 0 the first nonzero bin
    of each filter, row 1 one past its last (an all-zero filter gets 0, 0).
    Computed by a few device ops, without a host sync, once per filterbank
    tensor: a second call with the same, unmodified tensor returns the same
    bands. An inference-mode tensor has no version counter to show an edit,
    so its bands are computed on every call."""
    if mel_fb.is_inference():
        return _bands(mel_fb)
    key = id(mel_fb)
    hit = _BANDS.get(key)
    if (hit is not None and hit[0]() is mel_fb and hit[1] == mel_fb._version
            and hit[2] == mel_fb.data_ptr()):
        return hit[3]
    with torch.inference_mode(False):
        bands = _bands(mel_fb)
    _BANDS[key] = (weakref.ref(mel_fb, lambda _, k=key: _BANDS.pop(k, None)),
                   mel_fb._version, mel_fb.data_ptr(), bands)
    return bands


def kernel_transform(n_fft: int) -> str:
    """"fft" for the power-of-two sizes of ``KERNEL_N_FFT``, else "dft"."""
    return "fft" if n_fft in KERNEL_N_FFT else "dft"


def _dft_smem(n_fft: int, tf: int, n_mels: int) -> int:
    n_freq = n_fft // 2 + 1
    return 16 * n_fft + 8 * n_fft * tf + 4 * (tf * (n_freq + n_freq // 32 + 1) + 2 * n_mels)


def kernel_launch_config(n_fft: int, hop_length: int, n_mels: int):
    """(frames per tile, shared-memory bytes) of the kernel's launch, as
    ``csrc/fused_logmel.cu`` computes them; raises ValueError for what the
    kernel does not take. The FFT stages a tile's span of wav, or each frame
    on its own where hop is odd or at least n_fft (``frame_stride``), and
    always fits; the direct DFT halves its 16 frames a tile until the tile
    fits."""
    if hop_length <= 0:
        raise ValueError(f"fused_logmel kernel needs hop >= 1 (hop={hop_length})")
    if not 1 <= n_fft <= DFT_MAX_N_FFT:
        raise ValueError(f"fused_logmel kernel takes n_fft from 1 to {DFT_MAX_N_FFT}, "
                         f"not {n_fft}")
    if not 0 < n_mels <= n_fft // 2 + 1:
        raise ValueError(f"fused_logmel kernel needs 0 < n_mels <= n_fft/2 + 1 ({n_mels})")
    if kernel_transform(n_fft) == "fft":
        m = n_fft // 2
        v = m // 32
        tf = 16 if v <= 16 else 8
        fs = hop_length if hop_length % 2 == 0 and hop_length < n_fft else n_fft
        n_tab = m + m // 2 + v // 2 + 16
        span_pad = ((tf - 1) * fs + n_fft + 3) & ~3
        smem = 16 * n_tab + 4 * (n_fft + span_pad + tf * (m + m // 32 + 2) + 2 * n_mels)
    else:
        tf = next((t for t in (16, 8, 4, 2, 1) if _dft_smem(n_fft, t, n_mels) <= _MAX_SMEM), 0)
        smem = _dft_smem(n_fft, max(tf, 1), n_mels)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_logmel kernel: n_fft={n_fft}, hop={hop_length}, "
                         f"n_mels={n_mels} need {smem} bytes of shared memory "
                         f"(at most {_MAX_SMEM})")
    return tf, smem


def _launch(x, window, mel_fb, n_fft, hop_length, num_frames, mag_mode, log_mode,
            log_guard, mag_eps, mag_power):
    """One launch of the kernel on CUDA tensors (the old wrapper's direct
    route, which the registered op's CUDA implementation takes)."""
    if any(t.dtype != torch.float32 or t.device != x.device for t in (x, window, mel_fb)):
        raise ValueError("fused_logmel: x, window and mel_fb must be float32 on one device")
    n_mels = mel_fb.shape[0]
    kernel_launch_config(n_fft, hop_length, n_mels)
    x, window, mel_fb = x.contiguous(), window.contiguous(), mel_fb.contiguous()
    tables = (fft_tables if kernel_transform(n_fft) == "fft" else dft_table)(n_fft, x.device)
    bands = mel_bands(mel_fb)
    b, n = x.shape
    out = torch.empty((b, num_frames, n_mels), device=x.device, dtype=torch.float32)
    mag_arg = mag_power / 2.0 if mag_mode == "pow" else mag_eps  # the C entry's one slot
    lib = _build.library()
    with torch.cuda.device(x.device):  # the runtime launches on its current device
        err = lib.tsx_fused_logmel(
            x.data_ptr(), window.data_ptr(), mel_fb.data_ptr(), bands.data_ptr(),
            tables.data_ptr(), out.data_ptr(), b, n, n_fft, hop_length, n_mels,
            num_frames, _MAG_MODES[mag_mode], mag_arg, _LOG_MODES[log_mode], log_guard,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "fused_logmel")
    _build.LAUNCHES["fused_logmel"] += 1
    return out


@torch.library.custom_op("tpu_speech::fused_logmel", mutates_args=())
def fused_logmel_op(x: torch.Tensor, window: torch.Tensor, mel_fb: torch.Tensor, n_fft: int,
                    hop_length: int, num_frames: int, mag_mode: str, log_mode: str,
                    log_guard: float, mag_eps: float, mag_power: float = 2.0) -> torch.Tensor:
    """K1 as a registered op, which ``torch.export`` keeps in its graph:
    the kernel on a CUDA tensor, ``logmel_plain`` on a CPU one. The twiddle
    tables and mel bands stay cached inside (not graph inputs)."""
    kw = dict(n_fft=n_fft, hop_length=hop_length, num_frames=num_frames, mag_mode=mag_mode,
              log_mode=log_mode, log_guard=log_guard, mag_eps=mag_eps, mag_power=mag_power)
    if x.device.type == "cpu":
        return logmel_plain(x, window, mel_fb, **kw)
    return _launch(x, window, mel_fb, **kw)


@fused_logmel_op.register_fake
def _(x, window, mel_fb, n_fft, hop_length, num_frames, mag_mode, log_mode, log_guard,
      mag_eps, mag_power=2.0):
    return x.new_empty((x.shape[0], num_frames, mel_fb.shape[0]), dtype=torch.float32)


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
    mag_power: float = 2.0,
) -> torch.Tensor:
    """Fused wav -> log-mel through ``tpu_speech::fused_logmel``: the kernel
    on CUDA, ``logmel_plain`` on CPU. ``mag_power`` is read by
    ``mag_mode="pow"`` only."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_logmel: unsupported device {x.device}")
    return fused_logmel_op(x, window, mel_fb, n_fft, hop_length, num_frames, mag_mode,
                           log_mode, float(log_guard), float(mag_eps), float(mag_power))
