"""Normal draws as a function of a seed tensor, in plain tensor ops.

An exported serving graph takes its seed as an input (``cli/export_tts.py``),
so its noise cannot come from a ``torch.Generator`` or the global RNG
state: ``counter_normal`` hashes (seed, stream, element index) with the
counter-based hash of the attention kernels' dropout
(``ops/fused_attention.py::dropout_bits``, integer tensor ops that
``torch.export`` traces) and turns two 32-bit words into one standard
normal by Box–Muller. The same seed gives the same draw on any device up to
the rounding of float64 log and cos; JAX's draws are another stream.
"""

from __future__ import annotations

import math

import torch

from tpu_speech_torch.ops.fused_attention import dropout_bits


def counter_normal(seed: torch.Tensor, shape, device=None) -> torch.Tensor:
    """float32 standard normals of ``shape``, a function of the integer
    ``seed`` (a 0-d tensor, or an int) alone."""
    seed = torch.as_tensor(seed, device=device).to(torch.int64)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    u1 = (dropout_bits(seed, torch.zeros_like(seed), idx) + 1).double() * 2.0 ** -32  # (0, 1]
    u2 = dropout_bits(seed, torch.ones_like(seed), idx).double() * 2.0 ** -32  # [0, 1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.float().reshape(shape)
