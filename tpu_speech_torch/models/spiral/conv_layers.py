"""Masked 1-D convolutions with TF-style padding and length tracking.

Port of ``tpu_speech/models/spiral/conv_layers.py`` (``create_pad_mask:19``,
``tf_pad_1d:24``, ``Conv1dTF:51``, ``ConvNormAct:129``,
``ProjUpsampling:178``). Public tensors are channels-last (B, T, C) as in the
JAX package; each conv transposes to PyTorch's (B, C, T) around
``F.conv1d``. Parameters carry the reference state_dict names
(``conv.conv.weight``, ``norm.weight``, ``proj.conv.conv.weight``).

BatchNorm follows flax's ``nn.BatchNorm`` in training: batch statistics over
(B, T), padded frames included, and the running variance updated with the
BIASED batch variance (``FlaxBatchNorm1d``); PyTorch's ``nn.BatchNorm1d``
stores the unbiased one. Over N data-parallel ranks the statistics are
those of the global batch, as flax computes them over the whole sharded
array: the moments' sums are all-reduced in the forward and their gradients
in the backward (``_GlobalMoments``), so every rank normalizes alike and
keeps equal running statistics; under the seq axis the same sums cover
every rank's frames. Dropout draws from an explicit ``DropoutRng``.

``causal=True`` is the streaming-trainable mode (``Conv1dTF:51``): the
time pad is (k - 1, 0), so output frame t reads inputs up to t * stride only.
The chunk-incremental step (``models/spiral/streaming.py``) prepends each
layer's (k - 1)-frame input tail itself and runs the same weights unpadded.
The activations are ``relu`` and ``hardtanh`` (a clip to [-1, 1]).

Not ported yet: ``Conv2dTF`` (no SPIRAL config builds one).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.parallel import distributed
from tpu_speech_torch.parallel import seq as seq_axis

from tpu_speech_torch.models.spiral.dropout import dropout


def create_pad_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """True at PADDED positions (reference convention), (B, T); under the seq
    axis at this rank's global frame positions."""
    return seq_axis.positions(max_len, lens.device)[None, :] >= lens[:, None]


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
    """1d conv on (B, T, C), TF 'same' padding (or (k - 1, 0) when
    ``causal``), mask-aware.

    Padded frames are zeroed before every conv with kernel > 1; with stride
    s the lengths become ceil(len / s) and the pad mask is rebuilt. Under the
    seq axis (``parallel/seq.py``) x holds this rank's frames: the conv runs
    unpadded on them with the (pad left, k - s - pad left) frames its window
    reaches in the neighbours (``halo``), and the lengths stay global.
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True, causal: bool = False,
                 device=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.pads = ((kernel_size - 1, 0) if causal
                     else tf_pad_1d(kernel_size, stride, in_channels))
        self.conv = nn.Conv1d(in_channels, filters, kernel_size, stride,
                              bias=use_bias, device=device)

    def forward(self, x, lens, pad_mask=None):
        if pad_mask is not None and self.kernel_size > 1:
            x = x.masked_fill(pad_mask[:, :, None], 0.0)
        if seq_axis.current() is not None and self.kernel_size > 1:
            # this rank's frames of the time axis: the window's reach into
            # each neighbour, zeros at the axis's ends (the pad)
            left = self.pads[0]
            x = seq_axis.halo(x, left, self.kernel_size - self.stride - left)
            y = self.conv(x.transpose(1, 2)).transpose(1, 2)
        else:
            y = self.conv(F.pad(x.transpose(1, 2), self.pads)).transpose(1, 2)
        if self.stride > 1:
            lens = (lens + self.stride - 1) // self.stride
            pad_mask = create_pad_mask(lens, y.shape[1])
        return y, lens, pad_mask


class _GlobalMoments(torch.autograd.Function):
    """(E[x], E[x^2]) per channel of x (B, C, T) over the global batch:
    the local sums and count all-reduced over the batch group in one call. The backward sums the
    moments' gradients over the ranks (each rank's loss is its piece of the
    global loss) before the local chain rule."""

    @staticmethod
    def forward(ctx, x):
        c = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2)), x.square().sum(dim=(0, 2)),
                          x.new_tensor([x.shape[0] * x.shape[2]])])
        distributed.batch_all_reduce_(sums)
        n = sums[2 * c]
        ctx.save_for_backward(x, n)
        return sums[:c] / n, sums[c:2 * c] / n

    @staticmethod
    def backward(ctx, g_mean, g_mean2):
        x, n = ctx.saved_tensors
        c = x.shape[1]
        g = torch.cat([torch.zeros(c, device=x.device) if g is None else g
                       for g in (g_mean, g_mean2)])
        distributed.batch_all_reduce_(g)
        return (g[:c, None] + 2.0 * x * g[c:, None]) / n


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same parameters, buffers and names) with flax's
    training semantics (``flax.linen.BatchNorm``, use_fast_variance):
    mean = E[x], var = max(0, E[x^2] - mean^2) over (B, T); the running
    statistics move by ``momentum`` toward the batch mean and the BIASED
    batch variance. Eval mode normalizes with the running statistics, as
    torch does.

    A bf16 input (bf16 parameters under the steps' mixed precision) is
    normalized as flax 0.12 does it (``force_float32_reductions``): the
    statistics and the affine in float32, the running statistics float32
    buffers, the output rounded to the input's dtype once."""

    def forward(self, x):  # x (B, C, T)
        if not self.training:
            return super().forward(x)
        xf = x.float()
        if distributed.batch_count() > 1:
            mean, mean2 = _GlobalMoments.apply(xf)
        else:
            mean = xf.mean(dim=(0, 2))
            mean2 = xf.square().mean(dim=(0, 2))
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum  # the torch convention: weight of the new value
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()  # flax's order
        y = (xf - mean[None, :, None]) * mul[None, :, None] + self.bias.float()[None, :, None]
        return y.to(x.dtype)


def activation(y: torch.Tensor, act_func: Optional[str]) -> torch.Tensor:
    """``relu``, ``hardtanh`` (clip to [-1, 1]) or none
    (``conv_layers.py:169-172``)."""
    if act_func == "relu":
        return F.relu(y)
    if act_func == "hardtanh":
        return torch.clamp(y, -1.0, 1.0)
    return y


_ACTS = (None, "relu", "hardtanh")


class ConvNormAct(nn.Module):
    """conv -> {ln | bn | none} -> {relu | hardtanh | none} -> dropout, with
    length and mask tracking (convolution_layers.py:62-102). LayerNorm epsilon
    is ``ln_eps`` (1e-5, as the JAX module); BatchNorm is ``FlaxBatchNorm1d``
    with flax's momentum 0.99 (torch's 0.01) and epsilon 1e-3."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Sequence[int], stride: Sequence[int] = (1,),
                 norm_type: Optional[str] = None,
                 act_func: Optional[str] = None, dropout: float = 0.0,
                 ln_eps: float = 1e-5, bias: Optional[bool] = None,
                 causal: bool = False, device=None):
        super().__init__()
        if act_func not in _ACTS:
            raise NotImplementedError(f"act_func={act_func!r} is not ported")
        use_bias = bias if bias is not None else norm_type is None
        self.conv = Conv1dTF(in_channels, filters, kernel_size[0], stride[0],
                             use_bias=use_bias, causal=causal, device=device)
        if norm_type == "ln":
            self.norm = nn.LayerNorm(filters, eps=ln_eps, device=device)
        elif norm_type == "bn":
            self.norm = FlaxBatchNorm1d(filters, eps=1e-3, momentum=0.01,
                                        device=device)
        elif norm_type is None:
            self.norm = None
        else:
            raise NotImplementedError(f"norm_type={norm_type!r} is not ported")
        self.norm_type = norm_type
        self.act_func = act_func
        self.dropout = dropout

    def forward(self, x, lens, pad_mask=None, rng=None):
        y, lens, pad_mask = self.conv(x, lens, pad_mask)
        if self.norm_type == "ln":
            y = self.norm(y)
        elif self.norm_type == "bn":
            y = self.norm(y.transpose(1, 2)).transpose(1, 2)
        y = activation(y, self.act_func)
        return dropout(y, self.dropout, self.training, rng), lens, pad_mask


class ProjUpsampling(nn.Module):
    """Conv projection to ``rate * filters`` channels, then time upsampling by
    a CHANNELS-LAST reshape (B, T, rate*F) -> (B, T*rate, F)
    (convolution_layers.py:26-59); lengths scale by ``rate``. ``causal``
    pads the projection (k - 1, 0). ``act_func`` takes what ``ConvNormAct``
    takes, but as in the JAX module only ``relu`` acts here: ``hardtanh``
    leaves the upsampled features as they are."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Sequence[int], rate: int,
                 norm_type: Optional[str] = None,
                 act_func: Optional[str] = None, dropout: float = 0.0,
                 ln_eps: float = 1e-5, use_bias: bool = True,
                 causal: bool = False, device=None):
        super().__init__()
        if act_func not in _ACTS:
            raise NotImplementedError(f"act_func={act_func!r} is not ported")
        self.filters, self.rate = filters, rate
        # a norm-free ConvNormAct keeps the reference name proj.conv.conv.*
        self.proj = ConvNormAct(in_channels, filters * rate, kernel_size,
                                (1,), None, None, 0.0, bias=use_bias,
                                causal=causal, device=device)
        if norm_type == "ln":
            self.norm = nn.LayerNorm(filters, eps=ln_eps, device=device)
        elif norm_type is None:
            self.norm = None
        else:
            raise NotImplementedError(f"norm_type={norm_type!r} is not ported")
        self.act_func = act_func
        self.dropout = dropout

    def forward(self, x, lens, rng=None):
        pad_mask = create_pad_mask(lens, x.shape[1])
        y, lens, _ = self.proj(x, lens, pad_mask)
        b, t, _ = y.shape
        y = y.reshape(b, t * self.rate, self.filters)
        lens = lens * self.rate
        if self.norm is not None:
            y = self.norm(y)
        if self.act_func == "relu":  # the JAX module applies relu only (conv_layers.py:207)
            y = F.relu(y)
        return dropout(y, self.dropout, self.training, rng), lens
