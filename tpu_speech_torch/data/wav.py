"""Waveform input (no soundfile/librosa dependency).

The port's own copy of ``read_wav`` and ``write_wav`` of
``tpu_speech/data/wav.py:9, 55-63``.
"""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile


def read_wav(path: str):
    """Read a wav file -> (float32 array in [-1, 1] (channels collapsed), sr)."""
    sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return wav, sr


def write_wav(path: str, wav: np.ndarray, sr: int):
    """Write float wav in [-1, 1] — or already-quantized int16 PCM — as a
    16-bit PCM file."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        scipy.io.wavfile.write(path, sr, wav)
        return
    pcm = np.clip(wav, -1.0, 1.0)
    scipy.io.wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))
