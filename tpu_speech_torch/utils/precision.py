"""bf16 serving copies of a model.

The JAX package serves in bf16 by casting every floating leaf of the
parameter tree (``bench.py::_cast_bf16``, ``cli/export_tts.py::_cast_bf16``);
the activations then follow the parameters' dtype. The counterpart here casts
a model's floating parameters and nothing else: constants that the JAX
forward computes stay float32, and so do the port's buffers (a blanket
``module.to(torch.bfloat16)`` would cast those too).
"""

from __future__ import annotations

import copy

import torch


def cast_params_bf16(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose floating parameters are bfloat16; its
    buffers keep their dtype, and ``module`` is left as it was."""
    out = copy.deepcopy(module)
    for p in out.parameters():
        if p.is_floating_point():
            p.data = p.data.to(torch.bfloat16)
    return out
