"""Waveform input and output (no soundfile/librosa dependency).

The port's own copy of ``tpu_speech/data/wav.py``: ``read_wav``,
``decode_to_wav`` (compressed audio through whichever of ffmpeg, flac or sox
the host has), ``read_audio`` and ``write_wav``.
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


def decode_to_wav(src_path: str, wav_path: str) -> bool:
    """Decode a compressed audio file (flac, ...) to 16-bit wav with
    whichever host tool exists (ffmpeg/flac/sox). Returns success."""
    import subprocess

    for cmd in (
        ["ffmpeg", "-y", "-loglevel", "quiet", "-i", src_path, wav_path],
        ["flac", "-s", "-f", "-d", src_path, "-o", wav_path],
        ["sox", src_path, wav_path],
    ):
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            return True
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
    return False


def read_audio(path: str):
    """Read wav natively; decode other formats via decode_to_wav first."""
    if path.lower().endswith(".wav"):
        return read_wav(path)
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        if not decode_to_wav(path, tmp.name):
            raise RuntimeError(f"no decoder available for {path}")
        return read_wav(tmp.name)


def write_wav(path: str, wav: np.ndarray, sr: int):
    """Write float wav in [-1, 1] — or already-quantized int16 PCM — as a
    16-bit PCM file."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        scipy.io.wavfile.write(path, sr, wav)
        return
    pcm = np.clip(wav, -1.0, 1.0)
    scipy.io.wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))
