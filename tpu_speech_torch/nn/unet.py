"""U-Net score estimator for the score-based diffusion decoder.

The port's counterpart of ``tpu_speech/nn/unet.py:23-277``, laid out as the
reference ``GradLogPEstimator2d`` (Grad-TTS/model/diffusion.py:16-216):
channels-first (B, C, F, T) activations, which are cuDNN's, and the
reference's module tree (``downs.{i}.0.block1.block.0``,
``downs.{i}.2.fn.fn.to_qkv``, ``mlp.0``/``mlp.2``), so a reference
``state_dict`` loads as it is. Strided and transposed convs are
``nn.Conv2d``/``nn.ConvTranspose2d``, which have torch's geometry already:
the JAX package's subpixel rewrites (``nn/convops.py``) are TPU machinery
and are not ported. ``LinearAttention`` runs the reference's per-head
products where the JAX package runs one block-diagonal product (the same
arithmetic).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal time embedding in fp32 (diffusion.py:113-125)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor, scale: float = 1000.0) -> torch.Tensor:
        half = self.dim // 2
        dtype = torch.promote_types(t.dtype, torch.float32)  # at least fp32
        freqs = torch.exp(torch.arange(half, dtype=dtype, device=t.device)
                          * -(math.log(10000.0) / (half - 1)))
        args = scale * t.to(dtype)[:, None] * freqs[None, :]
        return torch.cat([args.sin(), args.cos()], dim=-1)


def promoted(layers: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``layers`` on x, each ``nn.Linear`` in the promoted dtype of its input
    and weight, as flax's ``Dense`` computes: the fp32 time embedding meets
    bf16 weights in fp32. In fp32 this is ``layers(x)``."""
    for layer in layers:
        if isinstance(layer, nn.Linear):
            dt = torch.promote_types(x.dtype, layer.weight.dtype)
            x = F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))
        else:
            x = layer(x)
    return x


def conv_as(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d`` or ``nn.ConvTranspose2d``) on x with x,
    its weight and its bias in ``dtype``: the JAX package's convs cast their
    input to the weight's dtype, its dense layers compute in the promoted
    dtype and the linear attention's projection in the input's. In fp32
    this is ``conv(x)``."""
    if x.dtype == dtype == conv.weight.dtype:
        return conv(x)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x.to(dtype), w, b, conv.stride, conv.padding)
    return F.conv2d(x.to(dtype), w, b, conv.stride, conv.padding)


def _promote(x: torch.Tensor, layer: nn.Module) -> torch.dtype:
    return torch.promote_types(x.dtype, layer.weight.dtype)


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> Mish, mask-aware (diffusion.py:49-58)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(dim, dim_out, 3, padding=1),
                                   nn.GroupNorm(groups, dim_out), Mish())

    def forward(self, x, mask):
        # the conv in its weight's dtype, as ``nn/convops.py`` casts a mixed
        # input (the fp32 sum of a bf16 block and the fp32 time embedding)
        return self.block((x * mask).to(self.block[0].weight.dtype)) * mask


class ResnetBlock(nn.Module):
    """Two conv blocks, the time embedding added between them, and a residual
    (diffusion.py:61-79)."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups=groups)
        self.block2 = Block(dim_out, dim_out, groups=groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, mask, time_emb):
        h = self.block1(x, mask) + promoted(self.mlp, time_emb)[:, :, None, None]
        h = self.block2(h, mask)
        if isinstance(self.res_conv, nn.Identity):
            return h + x * mask
        # a dense layer in JAX: the promoted dtype (float32 where DiffVC's
        # float32 condition channels enter the body on bf16 weights)
        return h + conv_as(self.res_conv, x * mask, _promote(x, self.res_conv))


class LinearAttention(nn.Module):
    """Softmax-free linear attention over the (F, T) grid (diffusion.py:82-100).

    The key softmax runs over all F*T positions, padded frames included, as
    the reference's does: the output depends on the padded length.
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, f, t = x.shape
        # channels ordered (qkv, head, d), the reference's rearrange
        # the projection in x's dtype, to_out in the promoted one (JAX's
        # ``_QKVProj`` and dense ``to_out``)
        qkv = conv_as(self.to_qkv, x, x.dtype).reshape(b, 3, self.heads, self.dim_head, f * t)
        q, k, v = qkv.unbind(1)  # (B, H, d, N)
        k = k.softmax(dim=-1)
        context = torch.matmul(k, v.transpose(-1, -2))  # (B, H, d, e)
        out = torch.matmul(context.transpose(-1, -2), q)  # (B, H, e, N)
        out = out.reshape(b, self.heads * self.dim_head, f, t)
        return conv_as(self.to_out, out, _promote(out, self.to_out))


class Rezero(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.fn(x) * self.g


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Downsample(nn.Module):
    """conv3x3 stride 2: halves F and T (diffusion.py:30-36)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return conv_as(self.conv, x, self.conv.weight.dtype)


class Upsample(nn.Module):
    """ConvTranspose 4x4 stride 2: doubles F and T (diffusion.py:21-27)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return conv_as(self.conv, x, self.conv.weight.dtype)


class UNet(nn.Module):
    """The U-Net body that Grad-TTS's and DiffVC's estimators share
    (diffusion.py:127-216 in both references): 3 resolutions (dim_mults 1,
    2, 4), two resnet blocks and a rezero linear attention per level, masks
    downsampled by ``[..., ::2]``, then the final block and a 1x1 conv to one
    channel. ``F`` and ``T`` must be multiples of 4
    (``fix_len_compatibility``). The modules are attributes of the estimator
    itself, as the references' ``downs``, ``ups``, ``mid_block1`` ...
    ``final_conv`` are."""

    def _build_unet(self, dim_in: int, dim: int, dim_mults: Sequence[int], groups: int):
        dims = [dim_in, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_out, time_emb_dim=dim, groups=groups),
                ResnetBlock(d_out, d_out, time_emb_dim=dim, groups=groups),
                Residual(Rezero(LinearAttention(d_out))),
                Downsample(d_out) if not is_last else nn.Identity()]))
        mid_dim = dims[-1]
        self.mid_block1 = ResnetBlock(mid_dim, mid_dim, time_emb_dim=dim, groups=groups)
        self.mid_attn = Residual(Rezero(LinearAttention(mid_dim)))
        self.mid_block2 = ResnetBlock(mid_dim, mid_dim, time_emb_dim=dim, groups=groups)
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out * 2, d_in, time_emb_dim=dim, groups=groups),
                ResnetBlock(d_in, d_in, time_emb_dim=dim, groups=groups),
                Residual(Rezero(LinearAttention(d_in))),
                Upsample(d_in)]))
        self.final_block = Block(dim, dim, groups=groups)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def _unet(self, x, mask, t):
        """x (B, C, F, T), mask (B, 1, 1, T), t (B, dim) -> (B, F, T)."""
        hiddens = []
        masks = [mask]
        for i, (resnet1, resnet2, attn, downsample) in enumerate(self.downs):
            mask_down = masks[-1]
            x = resnet1(x, mask_down, t)
            x = resnet2(x, mask_down, t)
            x = attn(x)
            hiddens.append(x)
            if i < len(self.downs) - 1:
                x = downsample(x * mask_down)
                masks.append(mask_down[:, :, :, ::2])

        mask_mid = masks[-1]
        x = self.mid_block1(x, mask_mid, t)
        x = self.mid_attn(x)
        x = self.mid_block2(x, mask_mid, t)

        for resnet1, resnet2, attn, upsample in self.ups:
            mask_up = masks.pop()
            x = torch.cat((x, hiddens.pop()), dim=1)
            x = resnet1(x, mask_up, t)
            x = resnet2(x, mask_up, t)
            x = attn(x)
            x = upsample(x * mask_up)

        x = self.final_block(x, mask)
        return (self.final_conv(x * mask) * mask).squeeze(1)


class GradLogPEstimator2d(UNet):
    """U-Net noise estimator.

    ``forward(x, mask, mu, t, spk)`` takes the reference's layout: x and mu
    (B, F, T), mask (B, 1, T), t (B,), spk (B, spk_emb_dim) for a
    multi-speaker model; returns (B, F, T). Inputs are stacked as channels
    [mu, x (, spk)] into the ``UNet`` body.
    """

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4), groups: int = 8,
                 n_spks: int = 1, spk_emb_dim: int = 64, n_feats: int = 80,
                 pe_scale: float = 1000.0):
        super().__init__()
        self.dim, self.n_spks, self.pe_scale = dim, n_spks, pe_scale
        if n_spks > 1:
            self.spk_mlp = nn.Sequential(nn.Linear(spk_emb_dim, spk_emb_dim * 4), Mish(),
                                         nn.Linear(spk_emb_dim * 4, n_feats))
        self.time_pos_emb = SinusoidalPosEmb(dim)
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim))
        self._build_unet(2 + (1 if n_spks > 1 else 0), dim, dim_mults, groups)

    def forward(self, x, mask, mu, t, spk=None):
        # t, the mask and mu in x's dtype (``nn/unet.py:221-226``)
        t, mask, mu = t.to(x.dtype), mask.to(x.dtype), mu.to(x.dtype)
        t = promoted(self.mlp, self.time_pos_emb(t, scale=self.pe_scale))
        chans = [mu, x]
        if self.n_spks > 1:
            s = self.spk_mlp(spk)  # (B, F): the decoder's speaker conditioning
            chans.append(s[:, :, None].expand(-1, -1, x.shape[-1]))
        x = torch.stack(chans, 1)  # (B, C, F, T)
        return self._unet(x, mask.unsqueeze(1), t)  # mask (B, 1, 1, T)
