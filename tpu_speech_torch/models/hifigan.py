"""HiFi-GAN vocoder generator (V1 by default), for serving.

The port's counterpart of ``tpu_speech/models/hifigan.py:24-167``, with the
reference's module tree (Grad-TTS/hifi-gan/models.py:13-127: ``conv_pre``,
``ups.{i}``, ``resblocks.{i * num_kernels + j}.convs1.{c}``, ``conv_post``)
in channels-first (B, C, T). The convolutions hold plain weights: a trained
checkpoint's weight norm is folded at load
(``compat/jax_gradtts.py::fold_weight_norm``), as the reference's
``remove_weight_norm()`` does. The discriminators and GAN losses wait for
HiFi-GAN training.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """MRF residual block: 3x (lrelu -> dilated conv -> lrelu -> conv) (models.py:13-50)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, 1, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, 1, dilation=1,
                      padding=get_padding(kernel_size, 1)) for _ in dilation)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """The lighter variant: 2x (lrelu -> dilated conv) (models.py:53-70)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, 1, dilation=d,
                      padding=get_padding(kernel_size, d)) for d in dilation)

    def forward(self, x):
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """Mel (B, n_mels, T) -> waveform (B, 1, T * prod(upsample_rates)) in [-1, 1].

    V1: rates (8, 8, 2, 2), kernels (16, 16, 4, 4), 512 initial channels,
    MRF kernels (3, 7, 11) x dilations (1, 3, 5).
    """

    def __init__(self, resblock: str = "1",
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 n_mels: int = 80):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        block_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = nn.Conv1d(n_mels, upsample_initial_channel, 7, 1, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(upsample_initial_channel // (2 ** i), ch, k, u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(block_cls(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, 1, padding=3)

    def forward(self, x):
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = None
            for blk in blocks:
                xs = blk(x) if xs is None else xs + blk(x)
            x = xs / self.num_kernels
        # the default slope 0.01 here, not LRELU_SLOPE, as in the reference
        return torch.tanh(self.conv_post(F.leaky_relu(x)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Generator":
        """Seeded random weights as the reference inits them (``init_weights``
        of models.py: conv weights normal(0, 0.01)), biases uniform in
        +-1/sqrt(fan_in) (torch's default)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.01)
                m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1)
                             * fan_in ** -0.5)
        return self


def to_int16_pcm(wav: torch.Tensor) -> torch.Tensor:
    """Waveform in [-1, 1] -> int16 PCM on its own device (the wav file's
    payload, ``cli/inference.py:153-162``): clip, scale by 32767, truncate."""
    return (torch.clamp(wav.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
