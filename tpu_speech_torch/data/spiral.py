"""SPIRAL data pipeline: JSON manifests -> cropped waveform batches.

The port's own copy of what its runners use of ``tpu_speech/data/spiral.py``:
``read_manifest``, ``RandomNoisePerturbation`` and ``AudioAugmentor``, the
datasets ``AudioDataset``, ``TarredAudioDataset`` (``:358-464``) and
``AudioToTextDataset``, and the collates ``AudioBatchCollate`` and
``AudioTextBatchCollate``. Manifest lines
{'audio_filepath', 'duration', 'text'}, random crop to ``crop_size``
samples, optional clean+perturbed pairs for teacher-student pretraining,
char label encoding for CTC finetuning. Batches are fully static: (B,
crop_size) wavs. The other perturbations come with the slice that needs
them.
"""

from __future__ import annotations

import io
import json
import os
import random
import tarfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpu_speech_torch.data.wav import read_wav


def read_manifest(paths: str | Sequence[str], min_duration: float = 0.0,
                  max_duration: Optional[float] = None) -> List[Dict]:
    if isinstance(paths, str):
        paths = paths.split(",")
    entries = []
    for p in paths:
        with open(p.strip(), encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                item = json.loads(line)
                dur = item.get("duration", 0.0)
                if dur < min_duration:
                    continue
                if max_duration is not None and dur > max_duration:
                    continue
                entries.append(item)
    return entries


class RandomNoisePerturbation:
    """Splice real noise at random SNR (parts/perturb.py:478-582): sample a
    noise file from a manifest, random segment, mix at SNR ~ U(min, max) dB."""

    def __init__(self, manifest_path, min_snr_db=0.0, max_snr_db=30.0,
                 ratio: float = 1.0, rng=None, cache_size: int = 64):
        self.entries = read_manifest(manifest_path)
        self.min_snr, self.max_snr = min_snr_db, max_snr_db
        self.ratio = ratio
        self.rng = rng or random.Random()
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_size = cache_size

    def _load(self, path):
        if path not in self._cache:
            if len(self._cache) >= self._cache_size:
                self._cache.pop(next(iter(self._cache)))
            wav, _ = read_wav(path)
            self._cache[path] = wav
        return self._cache[path]

    def __call__(self, wav, sr):
        if self.rng.random() > self.ratio or not self.entries:
            return wav
        entry = self.rng.choice(self.entries)
        noise = self._load(entry["audio_filepath"])
        if len(noise) < len(wav):
            reps = int(np.ceil(len(wav) / max(len(noise), 1)))
            noise = np.tile(noise, reps)
        start = self.rng.randrange(max(len(noise) - len(wav), 1))
        noise = noise[start : start + len(wav)]
        snr_db = self.rng.uniform(self.min_snr, self.max_snr)
        p_sig = np.mean(wav**2) + 1e-12
        p_noise = np.mean(noise**2) + 1e-12
        scale = np.sqrt(p_sig / (p_noise * 10 ** (snr_db / 10)))
        return (wav + scale * noise).astype(np.float32)


class AudioAugmentor:
    """Probability-weighted perturbation pipeline (parts/perturb.py:823)."""

    def __init__(self, perturbations: Sequence[tuple] = ()):
        # [(prob, callable), ...]
        self.perturbations = list(perturbations)
        self.rng = random.Random()

    def __call__(self, wav, sr):
        for prob, p in self.perturbations:
            if self.rng.random() < prob:
                wav = p(wav, sr)
        return wav


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


class AudioDataset:
    """Speech-only dataset for pretraining: random crop to crop_size; with
    ``return_both`` yields (clean, perturbed) pairs (audio_to_text.py:220-377)."""

    def __init__(
        self,
        manifest_filepath,
        sample_rate: int = 16000,
        crop_size: Optional[int] = None,
        min_duration: float = 0.0,
        max_duration: Optional[float] = None,
        augmentor: Optional[AudioAugmentor] = None,
        return_both: bool = False,
        seed: int = 0,
        dup_factor: int = 1,
    ):
        self.entries = read_manifest(manifest_filepath, min_duration, max_duration)
        if dup_factor > 1:
            # reference dev_data_dup_factor: pad tiny dev sets to span epochs
            self.entries = self.entries * dup_factor
        self.sample_rate = sample_rate
        self.crop_size = crop_size
        self.augmentor = augmentor
        self.return_both = return_both
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.entries)

    def _load_cropped(self, path):
        wav, sr = read_wav(path)
        assert sr == self.sample_rate, (path, sr)
        if self.crop_size is not None and len(wav) > self.crop_size:
            start = self.rng.randrange(len(wav) - self.crop_size)
            wav = wav[start : start + self.crop_size]
        return wav

    def __getitem__(self, i):
        wav = self._load_cropped(self.entries[i]["audio_filepath"])
        if self.return_both:
            p_wav = wav.copy()
            if self.augmentor is not None:
                p_wav = self.augmentor(p_wav, self.sample_rate)
            return {"wav": wav, "p_wav": p_wav}
        if self.augmentor is not None:
            wav = self.augmentor(wav, self.sample_rate)
        return {"wav": wav}


class TarredAudioDataset:
    """Iterable dataset over tar shards of wav files (the reference's
    TarredAudioToCharDataset family, audio_to_text.py:798+): manifest entries
    are matched to tar members by file id (basename without extension).
    Streams members in shard order — no random access, suited to large
    corpora on blob storage. shard_id/num_shards splits shards across hosts;
    shuffle_n is a small reservoir shuffle within the stream."""

    def __init__(
        self,
        manifest_filepath,
        tar_filepaths: Sequence[str],
        sample_rate: int = 16000,
        crop_size: Optional[int] = None,
        min_duration: float = 0.0,
        max_duration: Optional[float] = None,
        augmentor: Optional[AudioAugmentor] = None,
        return_both: bool = False,
        shuffle_n: int = 0,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        tokenizer=None,
    ):
        if isinstance(tar_filepaths, str):
            tar_filepaths = tar_filepaths.split(",")
        entries = read_manifest(manifest_filepath, min_duration, max_duration)
        self.by_id = {
            os.path.splitext(os.path.basename(e["audio_filepath"]))[0]: e
            for e in entries
        }
        self.tar_filepaths = list(tar_filepaths)[shard_id::num_shards]
        self.sample_rate = sample_rate
        self.crop_size = crop_size
        self.augmentor = augmentor
        self.return_both = return_both
        self.shuffle_n = shuffle_n
        self.tokenizer = tokenizer
        self.rng = random.Random(seed + shard_id)
        self._n = len(self.by_id) // max(num_shards, 1)

    def __len__(self):
        return self._n

    def _make_item(self, wav):
        if self.crop_size is not None and len(wav) > self.crop_size:
            start = self.rng.randrange(len(wav) - self.crop_size)
            wav = wav[start : start + self.crop_size]
        if self.return_both:
            p_wav = wav.copy()
            if self.augmentor is not None:
                p_wav = self.augmentor(p_wav, self.sample_rate)
            return {"wav": wav, "p_wav": p_wav}
        if self.augmentor is not None:
            wav = self.augmentor(wav, self.sample_rate)
        return {"wav": wav}

    def _iter_items(self):
        for tar_path in self.tar_filepaths:
            with tarfile.open(tar_path, "r") as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    fid = os.path.splitext(os.path.basename(member.name))[0]
                    entry = self.by_id.get(fid)
                    if entry is None:
                        continue
                    wav, sr = read_wav(
                        io.BytesIO(tf.extractfile(member).read())
                    )
                    assert sr == self.sample_rate, (member.name, sr)
                    item = self._make_item(wav)
                    if self.tokenizer is not None:
                        item["labels"] = np.asarray(
                            self.tokenizer.text_to_ids(entry["text"]),
                            dtype=np.int32,
                        )
                        item["text"] = entry["text"]
                    yield item

    def __iter__(self):
        if self.shuffle_n <= 1:
            yield from self._iter_items()
            return
        buf = []
        for item in self._iter_items():
            buf.append(item)
            if len(buf) >= self.shuffle_n:
                yield buf.pop(self.rng.randrange(len(buf)))
        self.rng.shuffle(buf)
        yield from buf

    def iter_batches(self, batch_size: int, collate_fn, drop_last=True):
        batch = []
        for item in self:
            batch.append(item)
            if len(batch) == batch_size:
                yield collate_fn(batch)
                batch = []
        if batch and not drop_last:
            yield collate_fn(batch)


class AudioToTextDataset(AudioDataset):
    """Speech + transcript labels for CTC finetune (audio_to_text.py:380-712).
    ``tokenizer`` is any object with text_to_ids()."""

    def __init__(self, manifest_filepath, tokenizer, **kwargs):
        super().__init__(manifest_filepath, **kwargs)
        self.tokenizer = tokenizer

    def __getitem__(self, i):
        entry = self.entries[i]
        wav = self._load_cropped(entry["audio_filepath"])
        if self.augmentor is not None:
            wav = self.augmentor(wav, self.sample_rate)
        labels = np.asarray(
            self.tokenizer.text_to_ids(entry["text"]), dtype=np.int32
        )
        return {"wav": wav, "labels": labels, "text": entry["text"]}


class AudioBatchCollate:
    """Static (B, crop_size) wav batches (+ clean/perturbed pair)."""

    def __init__(self, crop_size: int):
        self.crop_size = crop_size

    def __call__(self, batch):
        b = len(batch)
        wavs = np.zeros((b, self.crop_size), dtype=np.float32)
        lens = np.zeros((b,), dtype=np.int32)
        both = "p_wav" in batch[0]
        p_wavs = np.zeros_like(wavs) if both else None
        p_lens = np.zeros_like(lens) if both else None
        for i, item in enumerate(batch):
            w = item["wav"][: self.crop_size]
            wavs[i, : len(w)] = w
            lens[i] = len(w)
            if both:
                pw = item["p_wav"][: self.crop_size]
                p_wavs[i, : len(pw)] = pw
                p_lens[i] = len(pw)
        out = {"wavs": wavs, "wav_lens": lens}
        if both:
            out["p_wavs"] = p_wavs
            out["p_wav_lens"] = p_lens
        return out


class AudioTextBatchCollate:
    """Static wav + label batches for CTC."""

    def __init__(self, max_samples: int, max_labels: int):
        self.max_samples = max_samples
        self.max_labels = max_labels

    def __call__(self, batch):
        b = len(batch)
        wavs = np.zeros((b, self.max_samples), dtype=np.float32)
        lens = np.zeros((b,), dtype=np.int32)
        labels = np.zeros((b, self.max_labels), dtype=np.int32)
        label_lens = np.zeros((b,), dtype=np.int32)
        texts = []
        for i, item in enumerate(batch):
            w = item["wav"][: self.max_samples]
            wavs[i, : len(w)] = w
            lens[i] = len(w)
            lab = item["labels"][: self.max_labels]
            labels[i, : len(lab)] = lab
            label_lens[i] = len(lab)
            texts.append(item["text"])
        return {
            "wavs": wavs, "wav_lens": lens,
            "labels": labels, "label_lens": label_lens, "texts": texts,
        }
