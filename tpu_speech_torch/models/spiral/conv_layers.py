"""Masked 1-D convolutions with TF-style padding and length tracking.

Port of ``tpu_speech/models/spiral/conv_layers.py`` (``create_pad_mask:19``,
``tf_pad_1d:24``, ``Conv1dTF:51``, ``ConvNormAct:129``,
``ProjUpsampling:178``). Public tensors are channels-last (B, T, C) as in the
JAX package; each conv transposes to PyTorch's (B, C, T) around
``F.conv1d``. Parameters carry the reference state_dict names
(``conv.conv.weight``, ``norm.weight``, ``proj.conv.conv.weight``).

Not ported yet: the causal/incremental (streaming) modes and ``Conv2dTF``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def create_pad_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at PADDED positions (reference convention), (B, T)."""
    return torch.arange(max_len, device=lens.device)[None, :] >= lens[:, None]


def tf_pad_1d(kernel: int, stride: int, in_channels: int) -> Tuple[int, int]:
    """TF 'same' pad amounts for the time dim of a 1d conv.

    Reference quirk: for stride 2 the asymmetric (k//2-1, k//2) pad is chosen
    when the CHANNEL count of the input is even (convolution_layers.py:225).
    """
    if kernel % 2 != 1:
        raise ValueError(f"TF-same padding needs an odd kernel, got {kernel}")
    p = kernel // 2
    if stride == 2 and in_channels % 2 == 0:
        return (p - 1, p)
    return (p, p)


class Conv1dTF(nn.Module):
    """1d conv on (B, T, C), TF 'same' padding, mask-aware.

    Padded frames are zeroed before every conv with kernel > 1; with stride
    s the lengths become ceil(len / s) and the pad mask is rebuilt.
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True, device=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.pads = tf_pad_1d(kernel_size, stride, in_channels)
        self.conv = nn.Conv1d(in_channels, filters, kernel_size, stride,
                              bias=use_bias, device=device)

    def forward(self, x, lens, pad_mask=None):
        if pad_mask is not None and self.kernel_size > 1:
            x = x.masked_fill(pad_mask[:, :, None], 0.0)
        y = self.conv(F.pad(x.transpose(1, 2), self.pads)).transpose(1, 2)
        if self.stride > 1:
            lens = (lens + self.stride - 1) // self.stride
            pad_mask = create_pad_mask(lens, y.shape[1])
        return y, lens, pad_mask


class ConvNormAct(nn.Module):
    """conv -> {ln | bn | none} -> {relu | none} -> dropout, with length and
    mask tracking (convolution_layers.py:62-102). LayerNorm epsilon is
    ``ln_eps`` (1e-5, as the JAX module); BatchNorm matches flax's
    (momentum 0.99 -> torch 0.01, epsilon 1e-3)."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Sequence[int], stride: Sequence[int] = (1,),
                 norm_type: Optional[str] = None,
                 act_func: Optional[str] = None, dropout: float = 0.0,
                 ln_eps: float = 1e-5, bias: Optional[bool] = None,
                 device=None):
        super().__init__()
        if act_func not in (None, "relu"):
            raise NotImplementedError(f"act_func={act_func!r} is not ported")
        use_bias = bias if bias is not None else norm_type is None
        self.conv = Conv1dTF(in_channels, filters, kernel_size[0], stride[0],
                             use_bias=use_bias, device=device)
        if norm_type == "ln":
            self.norm = nn.LayerNorm(filters, eps=ln_eps, device=device)
        elif norm_type == "bn":
            self.norm = nn.BatchNorm1d(filters, eps=1e-3, momentum=0.01,
                                       device=device)
        elif norm_type is None:
            self.norm = None
        else:
            raise NotImplementedError(f"norm_type={norm_type!r} is not ported")
        self.norm_type = norm_type
        self.act_func = act_func
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, lens, pad_mask=None):
        y, lens, pad_mask = self.conv(x, lens, pad_mask)
        if self.norm_type == "ln":
            y = self.norm(y)
        elif self.norm_type == "bn":
            y = self.norm(y.transpose(1, 2)).transpose(1, 2)
        if self.act_func == "relu":
            y = F.relu(y)
        return self.dropout(y), lens, pad_mask


class ProjUpsampling(nn.Module):
    """Conv projection to ``rate * filters`` channels, then time upsampling by
    a CHANNELS-LAST reshape (B, T, rate*F) -> (B, T*rate, F)
    (convolution_layers.py:26-59); lengths scale by ``rate``."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Sequence[int], rate: int,
                 norm_type: Optional[str] = None,
                 act_func: Optional[str] = None, dropout: float = 0.0,
                 ln_eps: float = 1e-5, use_bias: bool = True, device=None):
        super().__init__()
        if act_func not in (None, "relu"):
            raise NotImplementedError(f"act_func={act_func!r} is not ported")
        self.filters, self.rate = filters, rate
        # a norm-free ConvNormAct keeps the reference name proj.conv.conv.*
        self.proj = ConvNormAct(in_channels, filters * rate, kernel_size,
                                (1,), None, None, 0.0, bias=use_bias,
                                device=device)
        if norm_type == "ln":
            self.norm = nn.LayerNorm(filters, eps=ln_eps, device=device)
        elif norm_type is None:
            self.norm = None
        else:
            raise NotImplementedError(f"norm_type={norm_type!r} is not ported")
        self.act_func = act_func
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, lens):
        pad_mask = create_pad_mask(lens, x.shape[1])
        y, lens, _ = self.proj(x, lens, pad_mask)
        b, t, _ = y.shape
        y = y.reshape(b, t * self.rate, self.filters)
        lens = lens * self.rate
        if self.norm is not None:
            y = self.norm(y)
        if self.act_func == "relu":
            y = F.relu(y)
        return self.dropout(y), lens
