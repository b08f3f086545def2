"""DiffVC data pipeline: precomputed .npy mel/embedding dirs -> static batches.

The port's own copy of ``tpu_speech/data/diffvc.py``: host numpy, the
shuffles and crops drawn from ``random.Random(seed)`` in the same order, so
both packages build the same batches. Equivalent of DiffVC/data.py:54-337
(VCEncDataset/VCDecDataset + collates) with channels-last (T, F) mels.
Batches are fully static: (B, train_frames, n_mels).

Directory layout (same as the reference):
  data_dir/mels/<spk>/<id>_mel.npy         (n_mels, T) float
  data_dir/mels_<avg_type>/<spk>/<id>_avgmel.npy
  data_dir/embeds/<spk>/<id>_embed.npy     (256,)
  data_dir/textgrids/<spk>/<id>.TextGrid
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_speech_torch.data.textgrid import has_phone


def _load_mel(path: str) -> np.ndarray:
    mel = np.load(path)
    return mel.T.astype(np.float32)  # (n_mels, T) -> (T, n_mels)


class VCEncDataset:
    """(mel, phoneme-averaged mel) pairs for average-voice encoder training."""

    def __init__(
        self,
        data_dir: str,
        exc_file: Optional[str] = None,
        avg_type: str = "mode",
        test_speakers: Sequence[str] = (),
        filter_spn: bool = True,
        shuffle_seed: int = 37,
    ):
        self.data_dir = data_dir
        self.mel_x_dir = os.path.join(data_dir, "mels")
        self.mel_y_dir = os.path.join(data_dir, f"mels_{avg_type}")
        exceptions = set()
        if exc_file and os.path.exists(exc_file):
            with open(exc_file) as f:
                exceptions = {e.strip() + "_mel.npy" for e in f}
        self.train_info: List[Tuple[str, str]] = []
        self.test_info: List[Tuple[str, str]] = []
        for spk in sorted(os.listdir(self.mel_x_dir)):
            ids = sorted(os.listdir(os.path.join(self.mel_x_dir, spk)))
            ids = [m[:-8] for m in ids if m not in exceptions]
            if filter_spn:
                ids = [
                    m for m in ids
                    if not has_phone(
                        os.path.join(data_dir, "textgrids", spk, m + ".TextGrid")
                    )
                ]
            target = self.test_info if spk in test_speakers else self.train_info
            target += [(m, spk) for m in ids]
        rng = random.Random(shuffle_seed)
        rng.shuffle(self.train_info)

    def __len__(self):
        return len(self.train_info)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        mel_id, spk = self.train_info[index]
        x = _load_mel(os.path.join(self.mel_x_dir, spk, mel_id + "_mel.npy"))
        y = _load_mel(os.path.join(self.mel_y_dir, spk, mel_id + "_avgmel.npy"))
        return {"x": x, "y": y}


class VCEncBatchCollate:
    """Random aligned crop of (x, y) to train_frames (data.py:166-186)."""

    def __init__(self, train_frames: int = 128, n_mels: int = 80, seed: int = 0):
        self.train_frames = train_frames
        self.n_mels = n_mels
        self.rng = random.Random(seed)

    def __call__(self, batch):
        b = len(batch)
        tf = self.train_frames
        xs = np.zeros((b, tf, self.n_mels), dtype=np.float32)
        ys = np.zeros((b, tf, self.n_mels), dtype=np.float32)
        lengths = np.zeros((b,), dtype=np.int32)
        for i, item in enumerate(batch):
            x, y = item["x"], item["y"]
            max_start = max(x.shape[0] - tf, 0)
            start = self.rng.randrange(max_start) if max_start > 0 else 0
            ln = min(x.shape[0], tf)
            xs[i, :ln] = x[start : start + ln]
            ys[i, :ln] = y[start : start + ln]
            lengths[i] = ln
        return {"x": xs, "y": ys, "lengths": lengths}


class VCDecDataset:
    """(mel, speaker-embedding) pairs for decoder training (data.py:190-252)."""

    def __init__(
        self,
        data_dir: str,
        val_file: Optional[str] = None,
        exc_file: Optional[str] = None,
        test_speakers: Sequence[str] = (),
        min_utts_per_speaker: int = 10,
        shuffle_seed: int = 37,
    ):
        self.mel_dir = os.path.join(data_dir, "mels")
        self.emb_dir = os.path.join(data_dir, "embeds")
        exceptions = set()
        if exc_file and os.path.exists(exc_file):
            with open(exc_file) as f:
                exceptions = {e.strip() + "_mel.npy" for e in f}
        valid_ids = set()
        if val_file and os.path.exists(val_file):
            with open(val_file) as f:
                valid_ids = {v.strip() + "_mel.npy" for v in f}
        exceptions |= valid_ids

        speakers = [
            s for s in sorted(os.listdir(self.mel_dir))
            if s not in test_speakers
            and len(os.listdir(os.path.join(self.mel_dir, s)))
            >= min_utts_per_speaker
        ]
        self.valid_info = [(v[:-8], v.split("_")[0]) for v in sorted(valid_ids)]
        self.train_info = []
        for spk in speakers:
            ids = sorted(os.listdir(os.path.join(self.mel_dir, spk)))
            self.train_info += [
                (m[:-8], spk) for m in ids if m not in exceptions
            ]
        rng = random.Random(shuffle_seed)
        rng.shuffle(self.train_info)

    def __len__(self):
        return len(self.train_info)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        mel_id, spk = self.train_info[index]
        mel = _load_mel(os.path.join(self.mel_dir, spk, mel_id + "_mel.npy"))
        emb = np.load(
            os.path.join(self.emb_dir, spk, mel_id + "_embed.npy")
        ).astype(np.float32)
        return {"mel": mel, "c": emb}


class VCDecBatchCollate:
    """Two independent crops of the same utterance: source segment vs
    reference segment (data.py:316-337)."""

    def __init__(self, train_frames: int = 128, n_mels: int = 80, seed: int = 0):
        self.train_frames = train_frames
        self.n_mels = n_mels
        self.rng = random.Random(seed)

    def __call__(self, batch):
        b = len(batch)
        tf = self.train_frames
        mels1 = np.zeros((b, tf, self.n_mels), dtype=np.float32)
        mels2 = np.zeros((b, tf, self.n_mels), dtype=np.float32)
        lengths = np.zeros((b,), dtype=np.int32)
        embeds = np.zeros((b, batch[0]["c"].shape[-1]), dtype=np.float32)
        for i, item in enumerate(batch):
            mel = item["mel"]
            max_start = max(mel.shape[0] - tf, 0)
            s1 = self.rng.randrange(max_start) if max_start > 0 else 0
            s2 = self.rng.randrange(max_start) if max_start > 0 else 0
            ln = min(mel.shape[0], tf)
            mels1[i, :ln] = mel[s1 : s1 + ln]
            mels2[i, :ln] = mel[s2 : s2 + ln]
            lengths[i] = ln
            embeds[i] = item["c"].reshape(-1)
        return {"mel1": mels1, "mel2": mels2, "mel_lengths": lengths, "c": embeds}


def build_average_mels(
    data_dir: str,
    sample_rate: int = 22050,
    hop: int = 256,
    avg_type: str = "mode",
    round_decimals: int = 1,
):
    """Average-voice target builder (get_avg_mels.ipynb): per-phoneme
    utterance medians -> corpus mode -> paint TextGrid-aligned frames."""
    from collections import defaultdict

    from tpu_speech_torch.data.textgrid import get_tier

    mel_dir = os.path.join(data_dir, "mels")
    tg_dir = os.path.join(data_dir, "textgrids")
    out_dir = os.path.join(data_dir, f"mels_{avg_type}")

    per_phoneme = defaultdict(list)
    speakers = sorted(os.listdir(mel_dir))
    for spk in speakers:
        for tg in sorted(os.listdir(os.path.join(tg_dir, spk))):
            tiers = get_tier(os.path.join(tg_dir, spk, tg))
            mel = np.load(
                os.path.join(mel_dir, spk, tg.replace(".TextGrid", "_mel.npy"))
            )
            for iv in tiers:
                s = int(iv.start_time * sample_rate) // hop
                e = int(iv.end_time * sample_rate) // hop + 1
                per_phoneme[iv.text].append(
                    np.round(np.median(mel[:, s:e], axis=1), round_decimals)
                )

    modes = {}
    for ph, rows in per_phoneme.items():
        arr = np.asarray(rows)
        # scipy.stats.mode over utterances, per mel bin
        vals = []
        for j in range(arr.shape[1]):
            uniq, counts = np.unique(arr[:, j], return_counts=True)
            vals.append(uniq[np.argmax(counts)])
        modes[ph] = np.asarray(vals, dtype=np.float32)

    for spk in speakers:
        os.makedirs(os.path.join(out_dir, spk), exist_ok=True)
        for tg in sorted(os.listdir(os.path.join(tg_dir, spk))):
            tiers = get_tier(os.path.join(tg_dir, spk, tg))
            mel = np.load(
                os.path.join(mel_dir, spk, tg.replace(".TextGrid", "_mel.npy"))
            )
            out = mel.copy()
            for iv in tiers:
                s = int(iv.start_time * sample_rate) // hop
                e = int(iv.end_time * sample_rate) // hop + 1
                if iv.text in modes:
                    out[:, s:e] = modes[iv.text][:, None]
            np.save(
                os.path.join(
                    out_dir, spk, tg.replace(".TextGrid", "_avgmel.npy")
                ),
                out,
            )
    return modes


# Held-out speaker/sentence splits (DiffVC/data.py:19-33)
LIBRITTS_TEST_SPEAKERS = (
    "1401", "2238", "3723", "4014", "5126",
    "5322", "587", "6415", "8057", "8534",
)
VCTK_UNSEEN_SPEAKERS = (
    "p252", "p261", "p241", "p238", "p243",
    "p294", "p334", "p343", "p360", "p362",
)
VCTK_UNSEEN_SENTENCES = ("001", "002", "003", "004", "005")


def _vctk_sentence_filter(ids, unseen_sentences=VCTK_UNSEEN_SENTENCES):
    """Drop utterances whose sentence id (second '_' field) is held out
    (DiffVC/data.py:125, :269)."""
    return [
        m for m in ids
        if len(m.split("_")) < 2 or m.split("_")[1] not in unseen_sentences
    ]


class VCTKEncDataset(VCEncDataset):
    """VCTK variant of the encoder dataset (DiffVC/data.py:109-163)."""

    def __init__(self, data_dir, exc_file=None, avg_type="mode",
                 shuffle_seed=37):
        super().__init__(
            data_dir, exc_file, avg_type,
            test_speakers=VCTK_UNSEEN_SPEAKERS, shuffle_seed=shuffle_seed,
        )
        self.train_info = [
            (m, s) for m, s in self.train_info
            if m.split("_")[1] not in VCTK_UNSEEN_SENTENCES
            or len(m.split("_")) < 2
        ]


class VCTKDecDataset(VCDecDataset):
    """VCTK variant of the decoder dataset (DiffVC/data.py:256-313)."""

    def __init__(self, data_dir, shuffle_seed=37):
        super().__init__(
            data_dir, test_speakers=VCTK_UNSEEN_SPEAKERS,
            min_utts_per_speaker=1, shuffle_seed=shuffle_seed,
        )
        self.train_info = [
            (m, s) for m, s in self.train_info
            if len(m.split("_")) < 2
            or m.split("_")[1] not in VCTK_UNSEEN_SENTENCES
        ]
