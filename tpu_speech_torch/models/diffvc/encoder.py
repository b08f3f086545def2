"""DiffVC's "average voice" encoder: ``MelEncoder`` + ``PostNet``
(``FwdDiffusion``).

The port's counterpart of ``tpu_speech/models/diffvc/encoder.py:16-103``,
laid out as the reference (DiffVC/model/encoder.py:257-284, postnet.py:15-53,
vc.py:19-48): channels-first activations, mel (B, F, T) and mask (B, 1, T),
and the reference's module names (``encoder.prenet.conv_layers.{i}``,
``postnet.res_block.block1.block.0``), so a reference ``state_dict`` loads
as it is. The transformer is the glow-tts stack of ``nn/blocks.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_speech_torch.nn.blocks import ConvReluNorm, RelPosTransformer
from tpu_speech_torch.nn.unet import Mish


class MelEncoder(nn.Module):
    """mel (B, F, T) -> 'average-voice' features (B, F, T)."""

    def __init__(self, n_feats: int = 80, channels: int = 192, filters: int = 768,
                 heads: int = 2, layers: int = 6, kernel: int = 3, dropout: float = 0.1,
                 window_size: int = 4):
        super().__init__()
        self.init_proj = nn.Conv1d(n_feats, channels, 1)
        self.prenet = ConvReluNorm(channels, channels, channels, kernel_size=5, n_layers=3,
                                   p_dropout=0.5)
        self.encoder = RelPosTransformer(channels, filters, heads, layers, kernel, dropout,
                                         window_size=window_size)
        self.term_proj = nn.Conv1d(channels, n_feats, 1)

    def forward(self, x, x_mask):
        x = self.init_proj(x * x_mask)
        x = self.prenet(x, x_mask)
        x = self.encoder(x, x_mask)
        return self.term_proj(x * x_mask)


class PostNetBlock(nn.Module):
    """conv 7x7 -> GroupNorm(8) -> Mish, masked (postnet.py:15-23)."""

    def __init__(self, dim: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(dim, dim, 7, padding=3), nn.GroupNorm(groups, dim),
                                   Mish())

    def forward(self, x, mask):
        return self.block(x * mask) * mask


class PostNetResBlock(nn.Module):
    """Two blocks and a 1x1 residual (postnet.py:26-38)."""

    def __init__(self, dim: int, groups: int = 8):
        super().__init__()
        self.block1 = PostNetBlock(dim, groups)
        self.block2 = PostNetBlock(dim, groups)
        self.res = nn.Conv2d(dim, dim, 1)

    def forward(self, x, mask):
        h = self.block2(self.block1(x, mask), mask)
        return self.res(x * mask) + h


class PostNet(nn.Module):
    """2-D conv residual refinement of the encoder output over the (F, T)
    grid (postnet.py:41-53): (B, F, T) -> (B, F, T)."""

    def __init__(self, dim: int, groups: int = 8):
        super().__init__()
        self.init_conv = nn.Conv2d(1, dim, 1)
        self.res_block = PostNetResBlock(dim, groups)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def forward(self, x, mask):
        x, mask = x.unsqueeze(1), mask.unsqueeze(1)  # (B, 1, F, T), (B, 1, 1, T)
        x = self.init_conv(x * mask)
        x = self.res_block(x, mask)
        return self.final_conv(x * mask).squeeze(1)


class FwdDiffusion(nn.Module):
    """MelEncoder + PostNet (vc.py:19-48): mel (B, F, T), mask (B, 1, T) ->
    the average-voice mel (B, F, T). ``compute_loss`` is stage 1's training
    loss (``tpu_speech/models/diffvc/encoder.py:100``)."""

    def __init__(self, n_feats: int = 80, channels: int = 192, filters: int = 768,
                 heads: int = 2, layers: int = 6, kernel: int = 3, dropout: float = 0.1,
                 window_size: int = 4, dim: int = 128):
        super().__init__()
        self.n_feats = n_feats
        self.encoder = MelEncoder(n_feats, channels, filters, heads, layers, kernel, dropout,
                                  window_size)
        self.postnet = PostNet(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.postnet(self.encoder(x, mask), mask)

    def compute_loss(self, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The masked MSE to the phoneme-averaged mel ``y`` (B, F, T), over
        sum(mask) x n_feats."""
        return masked_mse(self(x, mask), y, mask, self.n_feats)


def masked_mse(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
               n_feats: int, count=None) -> torch.Tensor:
    """``FwdDiffusion.compute_loss`` on a prediction (``encoder.py:100-103``):
    over (``count``, the global batch's frames over N ranks, or sum(mask))
    x n_feats."""
    denom = torch.sum(mask) if count is None else count.to(mask.dtype)
    return torch.sum((pred - y) ** 2 * mask) / (denom * n_feats)
