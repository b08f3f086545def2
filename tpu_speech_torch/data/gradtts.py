"""Grad-TTS data pipeline: filelists -> padded numpy batches.

The port's own copy of ``tpu_speech/data/gradtts.py:25-152`` (the reference
TextMelDataset / TextMelSpeakerDataset and their collates,
Grad-TTS/data.py:26-186): numpy end to end, the mels computed on host threads
by ``audio/mel.py::mel_spectrogram_np``, batches zero-padded to multiples of
``X_PAD_MULTIPLE`` tokens and ``Y_PAD_MULTIPLE`` frames (then
``fix_len_compatibility``), so that a run sees few distinct shapes.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpu_speech_torch.audio.mel import mel_spectrogram_np
from tpu_speech_torch.data.wav import read_wav
from tpu_speech_torch.ops.masks import fix_len_compatibility
from tpu_speech_torch.text import CMUDict, intersperse, symbols, text_to_sequence


def parse_filelist(filelist_path: str, split_char: str = "|") -> List[List[str]]:
    with open(filelist_path, encoding="utf-8") as f:
        return [line.strip().split(split_char) for line in f if line.strip()]


class TextMelDataset:
    """filelist line: 'wav_path|text' (+ '|speaker_id' for the speaker variant)."""

    def __init__(
        self,
        filelist_path: str,
        cmudict_path: Optional[str] = None,
        add_blank: bool = True,
        n_fft: int = 1024,
        n_mels: int = 80,
        sample_rate: int = 22050,
        hop_length: int = 256,
        win_length: int = 1024,
        f_min: float = 0.0,
        f_max: float = 8000.0,
        multispeaker: bool = False,
        shuffle_seed: Optional[int] = 37,
    ):
        self.filelist = parse_filelist(filelist_path)
        self.cmudict = CMUDict(cmudict_path) if cmudict_path else None
        self.add_blank = add_blank
        self.n_fft = n_fft
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.win_length = win_length
        self.f_min = f_min
        self.f_max = f_max
        self.multispeaker = multispeaker
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(self.filelist)

    def __len__(self):
        return len(self.filelist)

    def get_text(self, text: str) -> np.ndarray:
        seq = text_to_sequence(text, dictionary=self.cmudict)
        if self.add_blank:
            seq = intersperse(seq, len(symbols))
        return np.asarray(seq, dtype=np.int32)

    def get_mel(self, filepath: str) -> np.ndarray:
        wav, sr = read_wav(filepath)
        if sr != self.sample_rate:
            raise ValueError(f"{filepath}: {sr} Hz, the config says {self.sample_rate}")
        return mel_spectrogram_np(
            wav[None], self.n_fft, self.n_mels, self.sample_rate, self.hop_length,
            self.win_length, self.f_min, self.f_max,
        )[0]  # (T, n_mels)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        line = self.filelist[index]
        item = {"x": self.get_text(line[1]), "y": self.get_mel(line[0])}
        if self.multispeaker:
            item["spk"] = np.asarray(int(line[2]), dtype=np.int32)
        return item


X_PAD_MULTIPLE = 16  # tokens
Y_PAD_MULTIPLE = 32  # mel frames


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class TextMelBatchCollate:
    """Zero-pad a list of items to a bucketed batch: y to a
    fix_len_compatibility multiple of ``Y_PAD_MULTIPLE`` frames, x to a
    multiple of ``X_PAD_MULTIPLE`` tokens."""

    def __call__(self, batch: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        b = len(batch)
        n_feats = batch[0]["y"].shape[-1]
        y_max = fix_len_compatibility(
            _round_up(max(item["y"].shape[0] for item in batch), Y_PAD_MULTIPLE))
        x_max = _round_up(max(item["x"].shape[0] for item in batch), X_PAD_MULTIPLE)

        y = np.zeros((b, y_max, n_feats), dtype=np.float32)
        x = np.zeros((b, x_max), dtype=np.int32)
        y_lengths = np.zeros((b,), dtype=np.int32)
        x_lengths = np.zeros((b,), dtype=np.int32)
        spks = np.zeros((b,), dtype=np.int32)
        has_spk = "spk" in batch[0]
        for i, item in enumerate(batch):
            yi, xi = item["y"], item["x"]
            y_lengths[i], x_lengths[i] = yi.shape[0], xi.shape[0]
            y[i, : yi.shape[0]] = yi
            x[i, : xi.shape[0]] = xi
            if has_spk:
                spks[i] = item["spk"]
        out = {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths}
        if has_spk:
            out["spk"] = spks
        return out
