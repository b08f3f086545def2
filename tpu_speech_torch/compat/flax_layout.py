"""Where a torch parameter keeps the flax leaf's last (output-feature) axis.

The layout translations of the converters (``compat/jax_spiral.py``,
``compat/jax_gradtts.py``; flax channels-last against torch channels-first),
read the other way: for each parameter, the torch dimension that holds the
flax leaf's last axis, or None where the flax leaf has rank < 2.

- Dense kernel (in, out)             -> Linear weight (out, in): dim 0
- conv kernel (k..., in/g, out)      -> Conv weight (out, in/g, k...): dim 0;
  a Dense stored as a k = 1 conv too
- conv-transpose kernel (k..., in, out) -> ConvTranspose weight (in, out, k...): dim 1
- Embedding (vocab, E)               -> Embedding weight (vocab, E): dim 1
- weight norm: ``weight_v`` as its conv (dim 0); ``weight_g``, whose flax
  leaf ``g`` is a vector (``jax_spiral.py:113-114``): None
- any other parameter (rel-pos embeddings, scalars, norms' scales) keeps
  the flax shape: its last dim from rank 2, None below

``parallel/mesh.py::shard_params_tp`` reads it to shard what JAX's
``shard_params_tp`` shards (``tests/test_torch_tp.py`` holds the two sets
equal on the Grad-TTS and SPIRAL models).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

_OUT_FIRST = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)
_TRANSPOSED = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def feature_dim(module: nn.Module, name: str, param: torch.Tensor) -> Optional[int]:
    """The dim of ``param`` (``module``'s own parameter ``name``) that holds
    the flax leaf's last axis; None where that leaf's rank is below 2."""
    if name == "weight_g":
        return None
    if name in ("weight", "weight_v") and param.dim() >= 2:
        if isinstance(module, _TRANSPOSED):
            return 1
        if isinstance(module, nn.Embedding):
            return 1
        if isinstance(module, _OUT_FIRST) or name == "weight_v":
            return 0
    return param.dim() - 1 if param.dim() >= 2 else None


def feature_dims(module: nn.Module) -> Dict[str, Optional[int]]:
    """``feature_dim`` of every parameter of ``module``, by its name in
    ``named_parameters``."""
    out = {}
    for prefix, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            out[f"{prefix}.{name}" if prefix else name] = feature_dim(mod, name, p)
    return out
