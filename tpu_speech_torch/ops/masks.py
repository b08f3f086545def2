"""Mask and alignment-path utilities.

The port's counterpart of ``tpu_speech/ops/masks.py:15-48`` (the reference
helpers of Grad-TTS/model/utils.py): ``sequence_mask``,
``fix_len_compatibility``, ``generate_path`` and ``duration_loss``
(``masks.py:51-53``).
"""

from __future__ import annotations

from typing import Optional

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask (B, T): True where position < length."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round ``length`` up to a multiple of 2**num_downsamplings (U-Net friendly)."""
    factor = 2 ** num_downsamplings_in_unet
    return ((length + factor - 1) // factor) * factor


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Expand durations into a binary monotone alignment path.

    duration: (B, Tx) non-negative token durations (may be fractional);
    mask: (B, Tx, Ty). Returns the (B, Tx, Ty) path in ``mask``'s dtype: row
    x covers the mel frames at positions p with cum[x-1] <= p < cum[x], the
    reference's cumsum trick.
    """
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=1)  # (B, Tx)
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    path_prev = torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return (path - path_prev) * mask


def duration_loss(logw: torch.Tensor, logw_gt: torch.Tensor, lengths: torch.Tensor,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE between predicted and target log-durations, normalized by token
    count (``count``, the global batch's over N ranks, or sum(lengths))."""
    return torch.sum((logw - logw_gt) ** 2) / (torch.sum(lengths) if count is None else count)
