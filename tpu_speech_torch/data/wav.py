"""Waveform input (no soundfile/librosa dependency).

The port's own copy of ``read_wav`` of ``tpu_speech/data/wav.py:9``.
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
