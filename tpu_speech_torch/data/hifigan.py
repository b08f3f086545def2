"""HiFi-GAN vocoder training data: wav files -> fixed-size waveform
segments (and, for fine-tuning, the acoustic model's mels).

The port's own copy of ``tpu_speech/data/hifigan.py``: ``load_wav_files``
(the upstream filelist, everything past '|' ignored), ``MelAudioDataset``
(0.95 peak normalisation, random crops from one ``np.random.default_rng(seed)``,
zero-padding of short wavs, the fine-tuning mel paired and cropped with its
wav, transposed when stored as (n_mels, T)) and ``MelAudioBatchCollate``.
The input mel and both loss mels are computed on the device by the GAN step
(``train/hifigan.py``), so a training batch is {"wav": (B, S)} and, when
fine-tuning, "mel": (B, S / hop, n_mels). The loader's threads share the one
generator, so the crops follow the order in which the threads reach it: with
``num_workers=1`` a run's crops are fixed by the seed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpu_speech_torch.data.wav import read_wav


def load_wav_files(training_file: str, wavs_dir: str = "") -> List[str]:
    """One relative path or file-id per line (the upstream filelist format:
    LJ001-0001|... also accepted — everything past '|' is ignored)."""
    files = []
    with open(training_file, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip().split("|")[0]
            if not ln:
                continue
            if not ln.endswith(".wav"):
                ln += ".wav"
            files.append(os.path.join(wavs_dir, ln) if wavs_dir else ln)
    return files


class MelAudioDataset:
    """Random fixed-size waveform segments for GAN vocoder training."""

    def __init__(
        self,
        files: Sequence[str],
        segment_size: int = 8192,
        sampling_rate: int = 22050,
        split: bool = True,
        fine_tuning: bool = False,
        input_mels_dir: Optional[str] = None,
        hop_size: int = 256,
        seed: int = 1234,
    ):
        self.files = list(files)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.split = split
        self.fine_tuning = fine_tuning
        self.input_mels_dir = input_mels_dir
        self.hop_size = hop_size
        self.rng = np.random.default_rng(seed)
        if fine_tuning and not input_mels_dir:
            raise ValueError("fine_tuning=True requires input_mels_dir")
        if segment_size % hop_size:
            raise ValueError("segment_size must be a multiple of hop_size")

    def __len__(self):
        return len(self.files)

    def _load(self, path: str) -> np.ndarray:
        wav, sr = read_wav(path)  # float32 in [-1, 1], channels collapsed
        if sr != self.sampling_rate:
            raise ValueError(
                f"{path}: {sr} Hz != dataset rate {self.sampling_rate}")
        wav = np.asarray(wav, dtype=np.float32)
        if not self.fine_tuning:
            # upstream peak-normalizes training audio to 0.95 full scale
            peak = float(np.abs(wav).max())
            if peak > 0:
                wav = wav * (0.95 / peak)
        return wav

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        wav = self._load(self.files[index])
        if not self.fine_tuning:
            if self.split:
                if len(wav) >= self.segment_size:
                    start = int(self.rng.integers(
                        0, len(wav) - self.segment_size + 1))
                    wav = wav[start:start + self.segment_size]
                else:
                    wav = np.pad(wav, (0, self.segment_size - len(wav)))
            return {"wav": wav}

        stem = os.path.splitext(os.path.basename(self.files[index]))[0]
        mel = np.load(os.path.join(self.input_mels_dir, stem + ".npy"))
        if mel.ndim != 2:
            raise ValueError(f"mel for {stem} must be 2-D, got {mel.shape}")
        if mel.shape[0] < mel.shape[1]:  # stored (n_mels, T) -> (T, n_mels)
            mel = mel.T
        frames = self.segment_size // self.hop_size
        if self.split:
            if mel.shape[0] >= frames:
                f0 = int(self.rng.integers(0, mel.shape[0] - frames + 1))
            else:
                mel = np.pad(mel, ((0, frames - mel.shape[0]), (0, 0)))
                f0 = 0
            mel = mel[f0:f0 + frames]
            s0 = f0 * self.hop_size
            wav = wav[s0:s0 + self.segment_size]
            if len(wav) < self.segment_size:
                wav = np.pad(wav, (0, self.segment_size - len(wav)))
        else:
            n = min(mel.shape[0], len(wav) // self.hop_size)
            mel, wav = mel[:n], wav[:n * self.hop_size]
        return {"wav": wav.astype(np.float32),
                "mel": mel.astype(np.float32)}


class MelAudioBatchCollate:
    """Stack fixed-size segments into static-shape arrays."""

    def __call__(self, batch: Sequence[Dict[str, np.ndarray]]):
        out = {"wav": np.stack([b["wav"] for b in batch])}
        if "mel" in batch[0]:
            out["mel"] = np.stack([b["mel"] for b in batch])
        return out
