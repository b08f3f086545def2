"""HiFi-GAN vocoder (V1 by default): the generator, the multi-period and
multi-scale discriminators and the GAN losses.

The port's counterpart of ``tpu_speech/models/hifigan.py``, with the
reference's module tree (Grad-TTS/hifi-gan/models.py:13-284: ``conv_pre``,
``ups.{i}``, ``resblocks.{i * num_kernels + j}.convs1.{c}``, ``conv_post``;
``discriminators.{i}.convs.{j}`` and ``conv_post`` of each discriminator) in
channels-first layouts. The convolutions hold plain weights: a trained
checkpoint's weight norm is folded at load
(``compat/jax_gradtts.py::fold_weight_norm``), as the reference's
``remove_weight_norm()`` does, and the discriminators carry neither weight
nor spectral norm, as the JAX package's do not. The discriminators take and
give the JAX package's layouts at their edges: wavs (B, N), scores (B, n);
their feature maps are channels-first, (B, C, N/p, p) and (B, C, n).
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


def uniform_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every conv's weight and bias uniform in +-1/sqrt(fan_in), drawn from
    ``generator``: the JAX package's ``_uniform`` init of its HiFi-GAN
    modules (hifigan.py:29-34), which its training CLI starts from. fan_in
    is the input channels per group times the kernel size, for a transposed
    conv too (JAX's ``ConvTranspose1dT:70``; torch's default counts its
    output channels there)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                w = m.weight
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose1d) else w.shape[1]) * \
                    w[0, 0].numel()
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * fan_in ** -0.5)
    return module


class DiscriminatorP(nn.Module):
    """Period discriminator (models.py:130-172, JAX ``:170-235``): the wav,
    reflect-padded on the right to a multiple of the period, folded to (B, 1,
    N/p, p), through (k, 1) convs of stride 3 and one of stride 1, then a
    (3, 1) conv to one channel."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024)):
        super().__init__()
        self.period = period
        pad = (get_padding(kernel_size, 1), 0)
        widths = [1, *channels]
        self.convs = nn.ModuleList(
            nn.Conv2d(c_in, c_out, (kernel_size, 1), (stride, 1), padding=pad)
            for c_in, c_out in zip(widths[:-1], widths[1:]))
        self.convs.append(nn.Conv2d(channels[-1], channels[-1], (kernel_size, 1), 1,
                                    padding=(2, 0)))
        self.conv_post = nn.Conv2d(channels[-1], 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        """x (B, N) -> (score (B, n), feature maps)."""
        b, n = x.shape
        pad = (self.period - n % self.period) % self.period
        if pad:
            x = F.pad(x, (0, pad), mode="reflect")
        h = x.reshape(b, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.flatten(1), fmap


# (channels, kernel, stride, padding, groups) of DiscriminatorS's convs
# (models.py:188-218, JAX hifigan.py:245-253)
MSD_SPECS = ((128, 15, 1, 7, 1), (128, 41, 2, 20, 4), (256, 41, 2, 20, 16),
             (512, 41, 4, 20, 16), (1024, 41, 4, 20, 16), (1024, 41, 1, 20, 16),
             (1024, 5, 1, 2, 1))


class DiscriminatorS(nn.Module):
    """Scale discriminator (models.py:188-218, JAX ``:238-265``): grouped
    1-D convs, then a k=3 conv to one channel."""

    def __init__(self, specs: Sequence[Sequence[int]] = MSD_SPECS):
        super().__init__()
        self.convs = nn.ModuleList()
        c_in = 1
        for ch, k, s, p, g in specs:
            self.convs.append(nn.Conv1d(c_in, ch, k, s, groups=g, padding=p))
            c_in = ch
        self.conv_post = nn.Conv1d(c_in, 1, 3, 1, padding=1)

    def forward(self, x):
        """x (B, N) -> (score (B, n), feature maps)."""
        h = x[:, None, :]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.flatten(1), fmap


class _Discriminators(nn.Module):
    """What the two multi-discriminators share. ``forward(x)`` runs every
    discriminator on one wav batch (B, N): (scores, feature maps), one list
    entry per discriminator. The JAX modules' ``__call__(y, y_hat)`` is
    ``forward(y)`` and ``forward(y_hat)``."""

    def _inputs(self, x):
        raise NotImplementedError

    def forward(self, x):
        scores, fmaps = [], []
        for d, xi in zip(self.discriminators, self._inputs(x)):
            s, f = d(xi)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps

    def init_weights(self, generator: torch.Generator):
        """Seeded random weights: the JAX package's uniform init."""
        return uniform_init_(self, generator)


class MultiPeriodDiscriminator(_Discriminators):
    """Periods (2, 3, 5, 7, 11) (models.py:175-185, JAX ``:268-280``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = (32, 128, 512, 1024)):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(DiscriminatorP(p, channels=channels)
                                            for p in periods)

    def _inputs(self, x):
        return [x] * len(self.discriminators)


class MultiScaleDiscriminator(_Discriminators):
    """Three scales, each after an average pool of 4, stride 2, padding 2
    that counts the padding (models.py:221-243, JAX ``:283-303``)."""

    def __init__(self, num_scales: int = 3, disc_specs: Sequence[Sequence[int]] = MSD_SPECS):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS(disc_specs)
                                            for _ in range(num_scales))
        self.meanpools = nn.ModuleList(nn.AvgPool1d(4, 2, padding=2)
                                       for _ in range(num_scales - 1))

    def _inputs(self, x):
        xs = [x]
        for pool in self.meanpools:
            xs.append(pool(xs[-1][:, None, :])[:, 0])
        return xs


# ---- GAN losses (models.py:287-313, JAX hifigan.py:309-336) ----


def feature_loss(fmap_r, fmap_g):
    """2 x the sum over discriminators and layers of mean |real - generated|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LS-GAN: sum of mean (1 - real)^2 + mean generated^2; returns (loss,
    real losses, generated losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + (r_loss + g_loss)
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LS-GAN: sum of mean (1 - generated)^2; returns (loss, per-output losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        item = torch.mean((1 - dg) ** 2)
        gen_losses.append(item)
        loss = loss + item
    return loss, gen_losses


def to_int16_pcm(wav: torch.Tensor) -> torch.Tensor:
    """Waveform in [-1, 1] -> int16 PCM on its own device (the wav file's
    payload, ``cli/inference.py:153-162``): clip, scale by 32767, truncate."""
    return (torch.clamp(wav.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
