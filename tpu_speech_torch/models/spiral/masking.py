"""Span/channel masking for SPIRAL student inputs (JAX-free twin).

Port of ``tpu_speech/models/spiral/masking.py``: ``gaussian_mask_emb:25``,
``compute_mask_indices:115`` and ``make_student_masks:182`` are numpy and
consume the ``np.random.Generator`` in exactly the order the JAX package
does, so one seed gives equal masks in both packages. ``apply_mask:208``
runs on the batch's device in torch. The fixed 'gaussian' mask embedding is
the port's copy of the JAX package's data file ``_gaussian_mask.npy``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

_GAUSSIAN_MASK_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "_gaussian_mask.npy")


def gaussian_mask_emb(num_features: int) -> np.ndarray:
    return np.load(_GAUSSIAN_MASK_PATH)[:num_features]


def _num_spans(rng: np.random.Generator, sz: int, mask_prob: float,
               mask_length: int, min_masks: int) -> int:
    """Expected span count with probabilistic rounding: floor(x + U[0,1))
    rounds x up with probability frac(x), so the *expected* masked fraction
    is mask_prob even when mask_prob*sz/mask_length is fractional (the
    distribution-defining convention of the reference / fairseq,
    wav2vec_modules.py:282-287)."""
    return max(min_masks, int(mask_prob * sz / float(mask_length) + rng.random()))


def _span_lengths(rng: np.random.Generator, n: int, mask_type: str,
                  mask_length: int, mask_other: float) -> np.ndarray:
    """Draw n span lengths for the given distribution family
    (wav2vec_modules.py:264-270 semantics): static = constant; uniform =
    U{mask_other..2*mask_length}; normal = round(N(mask_length, mask_other))
    clamped to >= 1; poisson = Poisson(mask_length)."""
    if mask_type == "static":
        return np.full(n, mask_length, dtype=np.int64)
    if mask_type == "uniform":
        return rng.integers(
            int(mask_other), mask_length * 2 + 1, size=n
        ).astype(np.int64)
    if mask_type == "normal":
        draws = rng.normal(mask_length, mask_other, size=n)
        return np.maximum(1, np.rint(draws).astype(np.int64))
    if mask_type == "poisson":
        return rng.poisson(mask_length, size=n).astype(np.int64)
    raise ValueError(f"unknown mask type {mask_type}")


def _concat_ranges(lengths: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of [0..l) for each l in lengths."""
    total = int(lengths.sum())
    seg_starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return np.arange(total, dtype=np.int64) - seg_starts


def _overlapping_spans(rng: np.random.Generator, sz: int,
                       lengths: np.ndarray) -> np.ndarray:
    """Place spans whose starts are distinct but whose bodies may overlap:
    starts drawn without replacement from [0, sz - min(lengths)), each
    expanded by its own length. Realized coverage is therefore <= the
    nominal sum (overlap shrinks it) — the standard wav2vec convention."""
    n = len(lengths)
    min_len = int(lengths.min())
    if sz - min_len <= n:
        # not enough distinct starts: shrink the start domain so the draw
        # below stays feasible (degenerate tiny-utterance case)
        min_len = sz - n - 1
    starts = rng.choice(sz - min_len, n, replace=False)
    return np.repeat(starts, lengths) + _concat_ranges(lengths)


def _disjoint_spans(rng: np.random.Generator, sz: int, lengths: np.ndarray,
                    min_space: int) -> np.ndarray:
    """Place spans greedily longest-first into a free-interval list so no
    two spans overlap and >= min_space frames separate them.

    Each span picks a free interval with probability proportional to the
    interval's width (among intervals that can hold it), then a uniform
    start inside it. The remainder-interval admission thresholds — left
    piece kept iff its width (minus spacing) can hold the *shortest*
    requested span, right piece kept iff strictly wider than twice that —
    match the reference's rules (wav2vec_modules.py:299-310), because they
    define the placement distribution."""
    keep = int(lengths.min())
    free = [(0, sz)]
    out: list[int] = []
    for length in sorted(lengths.tolist(), reverse=True):
        widths = np.array(
            [e - s if e - s >= length + min_space else 0 for s, e in free],
            dtype=np.float64,
        )
        total = widths.sum()
        if total == 0:
            break  # nowhere left to put this (or any shorter) span
        s, e = free.pop(int(rng.choice(len(free), p=widths / total)))
        start = int(rng.integers(s, e - length))
        out.extend(range(start, start + length))
        if start - s - min_space >= keep:
            free.append((s, start - min_space + 1))
        if e - start - keep - min_space > keep:
            free.append((start + length + min_space, e))
    return np.asarray(out, dtype=np.int64)


def compute_mask_indices(
    shape: Tuple[int, int],
    padding_lens: Optional[np.ndarray],
    mask_prob: float,
    mask_length: int,
    mask_type: str = "static",
    mask_other: float = 0.0,
    min_masks: int = 0,
    no_overlap: bool = False,
    min_space: int = 0,
    shrink_to_batch_min: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random span masks, (B, T) bool + per-sample mask counts.

    Original formulation, distribution-equivalent to the reference's
    compute_mask_indices (wav2vec_modules.py:207-326 / fairseq); the
    distribution-defining conventions (probabilistic span-count rounding,
    distinct-start overlapping placement, free-interval splitting rules)
    are preserved and property-tested in
    tests/test_masking_distribution.py.

    ``padding_lens`` gives valid lengths (the reference takes a padding
    mask; lengths are equivalent and cheaper). Spans never extend past a
    sample's valid length; with ``shrink_to_batch_min`` every sample's mask
    is subsampled to the batch-minimum count so downstream fixed-shape
    gathers stay rectangular.
    """
    if rng is None:
        rng = np.random.default_rng()
    bsz, all_sz = shape

    shared_num = _num_spans(rng, all_sz, mask_prob, mask_length, min_masks)
    per_sample: list = []
    for i in range(bsz):
        if padding_lens is None:
            sz, n = all_sz, shared_num
        else:
            sz = int(padding_lens[i])
            n = _num_spans(rng, sz, mask_prob, mask_length, min_masks)

        lengths = _span_lengths(rng, n, mask_type, mask_length, mask_other)
        if n == 0:
            per_sample.append(np.asarray([], dtype=np.int64))
            continue
        if lengths.sum() == 0:
            # all-zero draw (possible for poisson/normal): keep one span so
            # the sample is never left unmasked
            lengths[0] = min(mask_length, sz - 1)

        idx = (
            _disjoint_spans(rng, sz, lengths, min_space)
            if no_overlap
            else _overlapping_spans(rng, sz, lengths)
        )
        per_sample.append(np.unique(idx[idx < sz]))

    mask_num = np.asarray([len(s) for s in per_sample])
    floor = mask_num.min() if len(per_sample) else 0
    mask = np.zeros((bsz, all_sz), dtype=bool)
    for i, idx in enumerate(per_sample):
        if shrink_to_batch_min and len(idx) > floor:
            idx = rng.choice(idx, floor, replace=False)
        mask[i, idx] = True
    return mask, mask_num


def make_student_masks(
    batch_size: int,
    spec_len: int,
    num_features: int,
    spec_lens: np.ndarray,
    mask_prob: float = 0.5,
    mask_length: int = 20,
    mask_channel_prob: float = 0.4,
    mask_channel_length: int = 20,
    rng: Optional[np.random.Generator] = None,
):
    """Host-side helper producing both span and channel masks for one batch
    (mirrors apply_mask, st2vec_model.py:524-565, with base-config settings)."""
    if rng is None:
        rng = np.random.default_rng()
    time_mask, _ = compute_mask_indices(
        (batch_size, spec_len), spec_lens, mask_prob, mask_length,
        min_masks=2, shrink_to_batch_min=False, rng=rng,
    )
    chan_mask, _ = compute_mask_indices(
        (batch_size, num_features), None, mask_channel_prob,
        mask_channel_length, shrink_to_batch_min=False, rng=rng,
    )
    return time_mask, chan_mask


def apply_mask(
    specs: torch.Tensor,
    time_mask: torch.Tensor,
    chan_mask: Optional[torch.Tensor],
    mask_emb: torch.Tensor,
) -> torch.Tensor:
    """Fill masked (B, T) spans with the mask embedding and zero masked
    (B, C) channels. specs: (B, T, C)."""
    specs = torch.where(time_mask[:, :, None], mask_emb[None, None, :], specs)
    if chan_mask is not None:
        specs = specs.masked_fill(chan_mask[:, None, :], 0.0)
    return specs
