"""Speaker-verification batch sampling for GE2E training.

The port's own copy of ``tpu_speech/data/speaker_verification.py``: the
same draws from ``np.random.default_rng(seed)`` in the same order, so both
packages build the same batches. ``SpeakerVerificationSampler.state`` and
``load_state`` (the port's addition) carry the generator and the cyclers'
queues through a checkpoint, so a resumed run draws the batches a straight
run would. Reference: DiffVC/speaker_encoder/encoder/data_objects/ — a
SpeakerVerificationDataset of per-speaker directories of preprocessed mel
frame ``.npy`` files, a RandomCycler with bounded-starvation guarantees, and
SpeakerBatch random partial crops. Rebuilt host-side in numpy (the TPU only
ever sees the assembled static-shape (S*U, n_frames, n_mels) array).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


class RandomCycler:
    """Constrained random order over a sequence (random_cycler.py:5-38):
    over any m consecutive samples from n items, each item appears between
    m // n and ((m - 1) // n) + 1 times."""

    def __init__(self, source: Sequence, rng: np.random.Generator):
        if len(source) == 0:
            raise ValueError("Can't create RandomCycler from an empty collection")
        self.all_items = list(source)
        self.next_items: List = []
        self.rng = rng

    def sample(self, count: int) -> List:
        out: List = []
        while count > 0:
            if count >= len(self.all_items):
                perm = self.rng.permutation(len(self.all_items))
                out.extend(self.all_items[i] for i in perm)
                count -= len(self.all_items)
                continue
            n = min(count, len(self.next_items))
            out.extend(self.next_items[:n])
            count -= n
            self.next_items = self.next_items[n:]
            if not self.next_items:
                perm = self.rng.permutation(len(self.all_items))
                self.next_items = [self.all_items[i] for i in perm]
        return out

    def state(self) -> List[int]:
        """The queue as indices into the items."""
        return [self.all_items.index(item) for item in self.next_items]

    def load_state(self, state: Sequence[int]) -> None:
        self.next_items = [self.all_items[i] for i in state]


class _Speaker:
    def __init__(self, root: str, rng: np.random.Generator):
        self.root = root
        self.name = os.path.basename(root)
        files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith(".npy")
        )
        if not files:
            raise ValueError(f"speaker dir {root} has no .npy frame files")
        self.cycler = RandomCycler(files, rng)
        self.rng = rng

    def random_partials(self, count: int, n_frames: int) -> np.ndarray:
        """(count, n_frames, n_mels) random crops (utterance.py:15-27;
        shorter-than-n_frames utterances are edge-tiled — the reference's
        preprocessing guarantees length, ours degrades gracefully)."""
        out = []
        for path in self.cycler.sample(count):
            frames = np.load(path)
            if frames.shape[0] < n_frames:
                reps = -(-n_frames // frames.shape[0])
                frames = np.tile(frames, (reps, 1))
            start = (
                0 if frames.shape[0] == n_frames
                else int(self.rng.integers(0, frames.shape[0] - n_frames))
            )
            out.append(frames[start:start + n_frames])
        return np.stack(out).astype(np.float32)


class SpeakerVerificationSampler:
    """Yields (speakers_per_batch * utterances_per_speaker, n_frames, n_mels)
    batches: `speakers_per_batch` speakers via RandomCycler, each contributing
    `utterances_per_speaker` random partial utterances
    (speaker_verification_dataset.py:12-60, speaker_batch.py:7-15)."""

    def __init__(self, root: str, speakers_per_batch: int = 64,
                 utterances_per_speaker: int = 10, n_frames: int = 160,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        speaker_dirs = sorted(
            os.path.join(root, d) for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not speaker_dirs:
            raise ValueError(
                "No speakers found. Point at the directory containing the "
                "preprocessed per-speaker directories."
            )
        self.speakers = [_Speaker(d, self.rng) for d in speaker_dirs]
        self.speaker_cycler = RandomCycler(self.speakers, self.rng)
        self.speakers_per_batch = speakers_per_batch
        self.utterances_per_speaker = utterances_per_speaker
        self.n_frames = n_frames

    def state(self) -> dict:
        """The generator's state and every cycler's queue."""
        return {"rng": self.rng.bit_generator.state,
                "speakers": self.speaker_cycler.state(),
                "utterances": [s.cycler.state() for s in self.speakers]}

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.speaker_cycler.load_state(state["speakers"])
        for speaker, queue in zip(self.speakers, state["utterances"]):
            speaker.cycler.load_state(queue)

    def next_batch(self) -> np.ndarray:
        chosen = self.speaker_cycler.sample(self.speakers_per_batch)
        return np.concatenate([
            s.random_partials(self.utterances_per_speaker, self.n_frames)
            for s in chosen
        ])

    def __iter__(self):
        while True:
            yield self.next_batch()
