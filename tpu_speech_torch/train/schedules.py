"""Learning-rate schedules as functions of the update count (JAX-free twins).

Port of ``tpu_speech/train/schedules.py``: ``warmup_cosine:14`` (optax's
``warmup_cosine_decay_schedule``), ``noam:26``, ``square_annealing:38``,
``squareroot_annealing:56``, ``inverse_sqrt_annealing:74``,
``polynomial_hold:87`` and the registry ``SCHEDULES:106``. Each returns
``schedule(count) -> float``, where ``count`` is the number of updates
applied BEFORE this one, as optax reads it (``scale_by_learning_rate`` counts
from 0 and increments after the update). The arithmetic is float32, as the
JAX package computes it.
"""

from __future__ import annotations

import numpy as np

_f32 = np.float32


def warmup_cosine(lr, warmup_steps, max_steps, min_lr=0.0):
    """Linear warmup 0 -> lr over ``max(warmup_steps, 1)`` updates, then
    cosine decay to ``min_lr`` at ``max(max_steps, warmup_steps + 1)``."""
    warm = max(warmup_steps, 1)
    decay = max(max_steps, warmup_steps + 1) - warm
    alpha = 0.0 if lr == 0.0 else min_lr / lr

    def schedule(count: int) -> float:
        if count < warm:  # optax linear_schedule(0, lr, warm)
            frac = _f32(1) - _f32(count) / _f32(warm)
            return float((_f32(0) - _f32(lr)) * frac + _f32(lr))
        c = _f32(min(count - warm, decay))  # optax cosine_decay_schedule
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(decay)))
        return float(_f32(lr) * ((_f32(1) - _f32(alpha)) * cosine + _f32(alpha)))

    return schedule


def polynomial_hold(lr, warmup_steps, max_steps, hold_steps=0, power=1.0,
                    min_lr=0.0):
    """PolynomialHoldDecayAnnealing: linear warmup -> hold at lr ->
    polynomial decay to ``min_lr`` at ``max_steps``."""

    def schedule(count: int) -> float:
        warm = np.clip(_f32(count) / _f32(max(warmup_steps, 1)), _f32(0), _f32(1))
        decay_start = warmup_steps + hold_steps
        frac = np.clip(_f32(count - decay_start) / _f32(max(max_steps - decay_start, 1)),
                       _f32(0), _f32(1))
        decayed = _f32(min_lr) + (_f32(lr) - _f32(min_lr)) * (_f32(1) - frac) ** _f32(power)
        if count < warmup_steps:
            return float(_f32(lr) * warm)
        return float(_f32(lr) if count < decay_start else decayed)

    return schedule


def noam(lr, d_model, warmup_steps):
    """NoamAnnealing: lr * d^-0.5 * min(s^-0.5, s * w^-1.5), s >= 1."""
    scale = _f32(lr * d_model ** -0.5)
    w = _f32(warmup_steps ** -1.5)

    def schedule(count: int) -> float:
        s = max(_f32(count), _f32(1))
        return float(scale * min(s ** _f32(-0.5), s * w))

    return schedule


def _annealing(lr, warmup_steps, max_steps, min_lr, mult):
    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(_f32(lr) * np.clip(_f32(count) / _f32(max(warmup_steps, 1)),
                                            _f32(0), _f32(1)))
        frac = np.clip(_f32(count - warmup_steps) / _f32(max(max_steps - warmup_steps, 1)),
                       _f32(0), _f32(1))
        return float(_f32(min_lr) + _f32(lr - min_lr) * mult(_f32(1) - frac))

    return schedule


def square_annealing(lr, warmup_steps, max_steps, min_lr=0.0):
    """SquareAnnealing: warmup, then min_lr + (lr - min_lr) (1 - frac)^2."""
    return _annealing(lr, warmup_steps, max_steps, min_lr, lambda x: x ** 2)


def squareroot_annealing(lr, warmup_steps, max_steps, min_lr=0.0):
    """SquareRootAnnealing: warmup, then min_lr + (lr - min_lr) sqrt(1 - frac)."""
    return _annealing(lr, warmup_steps, max_steps, min_lr, np.sqrt)


def inverse_sqrt_annealing(lr, warmup_steps):
    """InverseSquareRootAnnealing: lr * min(s / w, 1) * sqrt(w / max(s, w)),
    s >= 1, w = max(warmup_steps, 1)."""
    w = _f32(max(warmup_steps, 1))

    def schedule(count: int) -> float:
        s = max(_f32(count), _f32(1))
        warm = np.clip(s / w, _f32(0), _f32(1))
        return float(_f32(lr) * warm * np.sqrt(w / max(s, w)))

    return schedule


SCHEDULES = {
    "CosineAnnealing": warmup_cosine,
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": squareroot_annealing,
    "InverseSquareRootAnnealing": inverse_sqrt_annealing,
    "PolynomialHoldDecayAnnealing": polynomial_hold,
    "NoamAnnealing": noam,
}
