"""Explicit random sources for the training forward, and flax-style dropout.

The JAX package draws every training-time random bit from the ``dropout``
PRNG stream it threads through ``Module.apply``. The port threads one
``DropoutRng`` through the forward instead of using PyTorch's global state:

- ``host`` (a CPU ``torch.Generator``) draws the per-layer attention-dropout
  seeds (``wav2vec.py:171-177``: one int32 per layer per step) and the
  layerdrop keep draws (``wav2vec.py:322-326``). They stay on the host, so a
  dropped layer is skipped and the seed reaches the kernel without a device
  sync.
- ``device`` (a generator on the activations' device) draws every other
  dropout mask.

The bits cannot equal JAX's: parity tests run with dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class DropoutRng:
    host: torch.Generator
    device: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device) -> "DropoutRng":
        device = torch.device(device)
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(seed + 1))

    def attention_seed(self) -> int:
        """One non-negative int32 for a layer's attention-dropout mask."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))

    def keep_layer(self, layerdrop: float) -> bool:
        """Bernoulli(1 - layerdrop), drawn on the host."""
        return float(torch.rand(1, generator=self.host)) < 1.0 - layerdrop


def dropout(x: torch.Tensor, p: float, training: bool,
            rng: Optional[DropoutRng]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - p, scale kept values by
    1 / (1 - p). Identity unless training with p > 0."""
    if not training or p == 0.0:
        return x
    if rng is None:
        raise ValueError("training-mode dropout needs a DropoutRng")
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))
