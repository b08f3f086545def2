"""Jasper/QuartzNet-style conv ASR encoder blocks.

Port of ``tpu_speech/models/spiral/jasper.py`` (``JasperBlockCfg:23``,
``ACTIVATIONS``, ``_MaskedConv1d:44``, ``JasperBlock:72``,
``ConvASREncoder:117``): R-times-repeated (separable) 1-d conv -> BatchNorm
-> activation -> dropout sub-blocks with a projected residual, channels-last
(B, T, C) and mask-aware.

As in the JAX module:

- padded frames are zeroed before every conv with kernel > 1; the pad is
  symmetric, ``dilation * (k - 1) // 2``; the convs have no bias; a strided
  conv updates the lengths by the conv's output-length formula;
- the separable form is a depthwise conv (``groups = C``) then a 1x1 conv;
- BatchNorm is ``FlaxBatchNorm1d`` (flax's momentum 0.99, torch's 0.01; eps
  1e-3), its batch statistics over every frame, padded ones included;
- the residual is a Dense with bias then BatchNorm, added before the last
  activation. A residual block with ``stride > 1`` gets neither the
  residual nor the last activation (``jasper.py:101-113``): a fault of the
  reference kept for parity (ROADMAP Queue 3).

Parameter names: ``blocks.{i}.{dw,pw,conv}.{r}.weight`` (a conv's (out,
in/groups, k) weight), ``blocks.{i}.bn.{r}.*``, ``blocks.{i}.res_proj.*``,
``blocks.{i}.res_bn.*``; ``compat/jax_ctc_models.py`` maps them to the flax
tree's ``block_{i}/{dw,pw,conv,bn}_{r}``, ``res_proj``, ``res_bn``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.models.spiral.conv_layers import FlaxBatchNorm1d, create_pad_mask
from tpu_speech_torch.models.spiral.dropout import DropoutRng, dropout


@dataclasses.dataclass(frozen=True)
class JasperBlockCfg:
    filters: int
    kernel_size: int = 11
    repeat: int = 3
    stride: int = 1
    dilation: int = 1
    dropout: float = 0.1
    residual: bool = True
    separable: bool = False
    activation: str = "relu"  # jasper_activations registry (jasper.py:24)


# the reference's jasper_activations registry (parts/jasper.py:24)
ACTIVATIONS = {
    "relu": F.relu,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "selu": F.selu,
    "swish": F.silu,  # Swish(x) = x * sigmoid(x) = SiLU
}


class _MaskedConv1d(nn.Conv1d):
    """A bias-free ``nn.Conv1d`` on (B, T, C) that zeroes padded frames
    first (kernel > 1) and tracks lengths and the pad mask."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, device=None):
        pad = (dilation * (kernel_size - 1)) // 2
        super().__init__(in_channels, filters, kernel_size, stride, padding=pad,
                         dilation=dilation, groups=groups, bias=False, device=device)

    def forward(self, x, lens, pad_mask):
        k, s, d, p = self.kernel_size[0], self.stride[0], self.dilation[0], self.padding[0]
        if pad_mask is not None and k > 1:
            x = x.masked_fill(pad_mask[:, :, None], 0.0)
        y = self._conv_forward(x.transpose(1, 2), self.weight, None).transpose(1, 2)
        if s > 1:
            lens = (lens + 2 * p - d * (k - 1) - 1) // s + 1
            pad_mask = create_pad_mask(lens, y.shape[1])
        return y, lens, pad_mask


def _bn(channels: int, device) -> FlaxBatchNorm1d:
    return FlaxBatchNorm1d(channels, eps=1e-3, momentum=0.01, device=device)


class JasperBlock(nn.Module):
    def __init__(self, in_channels: int, cfg: JasperBlockCfg, device=None):
        super().__init__()
        c = self.cfg = cfg
        if c.activation not in ACTIVATIONS:
            raise ValueError(f"activation {c.activation!r} is not one of {sorted(ACTIVATIONS)}")
        ch = in_channels
        dw, pw, conv, bn = [], [], [], []
        for r in range(c.repeat):
            stride = c.stride if r == 0 else 1
            if c.separable:
                dw.append(_MaskedConv1d(ch, ch, c.kernel_size, stride, c.dilation, groups=ch,
                                        device=device))
                pw.append(_MaskedConv1d(ch, c.filters, 1, device=device))
            else:
                conv.append(_MaskedConv1d(ch, c.filters, c.kernel_size, stride, c.dilation,
                                          device=device))
            bn.append(_bn(c.filters, device))
            ch = c.filters
        self.dw, self.pw, self.conv = nn.ModuleList(dw), nn.ModuleList(pw), nn.ModuleList(conv)
        self.bn = nn.ModuleList(bn)
        self.res_proj = self.res_bn = None
        if c.residual and c.stride == 1:
            self.res_proj = nn.Linear(in_channels, c.filters, device=device)
            self.res_bn = _bn(c.filters, device)

    def forward(self, x, lens, rng: Optional[DropoutRng] = None):
        c = self.cfg
        act = ACTIVATIONS[c.activation]
        pad_mask = create_pad_mask(lens, x.shape[1])
        res_in = x
        h = x
        for r in range(c.repeat):
            if c.separable:
                h, lens, pad_mask = self.dw[r](h, lens, pad_mask)
                h, lens, pad_mask = self.pw[r](h, lens, pad_mask)
            else:
                h, lens, pad_mask = self.conv[r](h, lens, pad_mask)
            h = self.bn[r](h.transpose(1, 2)).transpose(1, 2)
            if not (r == c.repeat - 1 and c.residual):
                h = dropout(act(h), c.dropout, self.training, rng)
        if self.res_proj is not None:
            res = self.res_bn(self.res_proj(res_in).transpose(1, 2)).transpose(1, 2)
            h = dropout(act(h + res), c.dropout, self.training, rng)
        return h, lens


class ConvASREncoder(nn.Module):
    """Stack of JasperBlocks: specs (B, T, F) -> features (B, T', D)."""

    def __init__(self, in_features: int, blocks: Tuple[JasperBlockCfg, ...], device=None):
        super().__init__()
        mods, ch = [], in_features
        for cfg in blocks:
            mods.append(JasperBlock(ch, cfg, device=device))
            ch = cfg.filters
        self.blocks = nn.ModuleList(mods)
        self.output_dim = ch

    def forward(self, x, lens, rng: Optional[DropoutRng] = None):
        for block in self.blocks:
            x, lens = block(x, lens, rng)
        return x, lens
