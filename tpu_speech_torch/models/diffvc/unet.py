"""DiffVC's speaker- and reference-conditional U-Net score estimator.

The port's counterpart of ``tpu_speech/models/diffvc/unet.py:48-154``, laid
out as the reference (DiffVC/model/diffusion.py:17-106, modules.py:128-166):
channels-first activations and the reference's module names
(``ref_block.block11.0``, ``ref_block.mlp1.1``, ``cond_block.{0,2}``,
``downs.{i}.2.fn.fn``), so a reference ``state_dict`` loads as it is.

The condition is [time embedding, RefBlock(diffused reference mel), speaker
embedding] -> MLP, broadcast over the (F, T) grid as channels after [mean,
x]. The U-Net body is the one Grad-TTS uses (``nn/unet.py::UNet``): the
source length must be a multiple of 4; the reference mel may have any
length, because RefBlock does not downsample.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpu_speech_torch.nn.unet import Mish, SinusoidalPosEmb, UNet, promoted


def _ref_conv(dim_in: int, dim_out: int) -> nn.Sequential:
    """conv 3x3 -> InstanceNorm2d (affine, biased variance) -> GLU over the
    channels (halves them)."""
    return nn.Sequential(nn.Conv2d(dim_in, dim_out, 3, 1, 1),
                         nn.InstanceNorm2d(dim_out, affine=True), nn.GLU(dim=1))


class RefBlock(nn.Module):
    """Reference-mel summary: a conv/GLU pyramid with time-embedding
    injections, then a masked mean over the (F, T) grid -> (B, out_dim)."""

    def __init__(self, out_dim: int, time_emb_dim: int):
        super().__init__()
        base = out_dim // 4
        self.mlp1 = nn.Sequential(Mish(), nn.Linear(time_emb_dim, base))
        self.mlp2 = nn.Sequential(Mish(), nn.Linear(time_emb_dim, 2 * base))
        self.block11 = _ref_conv(1, 2 * base)
        self.block12 = _ref_conv(base, 2 * base)
        self.block21 = _ref_conv(base, 4 * base)
        self.block22 = _ref_conv(2 * base, 4 * base)
        self.block31 = _ref_conv(2 * base, 8 * base)
        self.block32 = _ref_conv(4 * base, 8 * base)
        self.final_conv = nn.Conv2d(4 * base, out_dim, 1)

    def forward(self, x, mask, time_emb):
        # x (B, 1, F, Tr), mask (B, 1, 1, Tr), time_emb (B, time_emb_dim).
        # Each conv in its weight's dtype (the JAX package's conv2d casts its
        # input) and each dense layer in the promoted dtype: on bf16 weights
        # the float32 time embedding makes the sums after mlp1 and mlp2
        # float32, as in JAX
        def conv(layer, y):
            first = layer[0] if isinstance(layer, nn.Sequential) else layer
            return layer((y * mask).to(first.weight.dtype))

        y = conv(self.block11, x)
        y = conv(self.block12, y)
        y = y + promoted(self.mlp1, time_emb)[:, :, None, None]
        y = conv(self.block21, y)
        y = conv(self.block22, y)
        y = y + promoted(self.mlp2, time_emb)[:, :, None, None]
        y = conv(self.block31, y)
        y = conv(self.block32, y)
        y = conv(self.final_conv, y) * mask
        # the masked mean: denominator sum(mask) * n_feats
        return y.sum((2, 3)) / (mask.sum((2, 3)) * x.shape[2])


class GradLogPEstimatorVC(UNet):
    """``forward(x, x_mask, mean, ref, ref_mask, c, t)``: x and mean (B, F,
    T), x_mask (B, 1, T), ref (B, F, Tr), ref_mask (B, 1, Tr), c (B,
    spk_emb_dim) the speaker embedding, t (B,) -> the score (B, F, T)."""

    def __init__(self, dim_base: int, dim_cond: int, use_ref_t: bool = True,
                 dim_mults: Sequence[int] = (1, 2, 4), groups: int = 8,
                 spk_emb_dim: int = 256):
        super().__init__()
        self.use_ref_t = use_ref_t
        self.time_pos_emb = SinusoidalPosEmb(dim_base)
        self.mlp = nn.Sequential(nn.Linear(dim_base, dim_base * 4), Mish(),
                                 nn.Linear(dim_base * 4, dim_base))
        cond_total = dim_base + spk_emb_dim
        if use_ref_t:
            self.ref_block = RefBlock(dim_cond, dim_base)
            cond_total += dim_cond
        self.cond_block = nn.Sequential(nn.Linear(cond_total, 4 * dim_cond), Mish(),
                                        nn.Linear(4 * dim_cond, dim_cond))
        self._build_unet(2 + dim_cond, dim_base, dim_mults, groups)

    def forward(self, x, x_mask, mean, ref, ref_mask, c, t):
        # the dtypes of the JAX estimator (``unet.py:111-130``) on bf16
        # weights and inputs: the time embedding and the condition float32,
        # so that [mean, x, cond] enters the U-Net body in float32
        condition = self.time_pos_emb(t)
        t = promoted(self.mlp, condition)
        if self.use_ref_t:
            ref_feat = self.ref_block(ref.unsqueeze(1), ref_mask.unsqueeze(1), t)
            condition = torch.cat([condition, ref_feat], 1)
        cond = promoted(self.cond_block, torch.cat([condition, c], 1))
        h = torch.stack([mean, x], 1)  # (B, 2, F, T)
        h = torch.cat([h, cond[:, :, None, None].expand(-1, -1, *h.shape[2:])], 1)
        return self._unet(h, x_mask.unsqueeze(1), t)
