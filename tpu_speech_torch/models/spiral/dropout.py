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

Over N data-parallel ranks (``seeded(..., rank=, row0=)``) the host
generator is seeded alike on every rank, so every rank skips the same
layers and draws the same attention seeds, as JAX's one global program does;
the device generator is seeded by (seed, rank), so no two ranks draw the same
dither, dropout or negatives. ``row0`` is the global row of the rank's first
batch item: the attention kernels key their dropout masks by the global row
(``ops/fused_attention.py::dropout_keep_mask``), so rank r's rows do not
repeat rank 0's masks.

Under the seq axis (``parallel/seq.py``) the ranks of a data group share
their generators, and ``dropout`` draws the mask of the whole time axis and
keeps the rank's frames: the group draws the unsharded step's bits.

The bits cannot equal JAX's: parity tests run with dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_speech_torch.parallel import seq as seq_axis


@dataclasses.dataclass
class DropoutRng:
    host: torch.Generator
    device: torch.Generator
    row0: int = 0  # the global batch row of this rank's first item

    @classmethod
    def seeded(cls, seed: int, device, rank: int = 0, row0: int = 0) -> "DropoutRng":
        """Rank 0's generators are those of a one-process run."""
        device = torch.device(device)
        # 32 bits: the CPU generator keeps no more of its seed
        dev_seed = seed + 1 if rank == 0 else (seed + 1 + rank * 0x9E3779B9) % 2**32
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(dev_seed), row0)

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
    seq = seq_axis.current()
    if seq is None:
        keep = torch.rand(x.shape, generator=rng.device, device=x.device) < 1.0 - p
    else:  # (B, T / S, ...) frames of the seq axis: the global draw, this rank's frames
        shape = (x.shape[0], x.shape[1] * seq.size, *x.shape[2:])
        draw = torch.rand(shape, generator=rng.device, device=x.device)
        keep = seq_axis.keep_frames(draw, seq) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))
