"""Seeded random weights for the port's diffusion models (Grad-TTS, DiffVC)."""

from __future__ import annotations

import torch
from torch import nn

from tpu_speech_torch.nn.blocks import RelPosMultiHeadAttention
from tpu_speech_torch.nn.unet import Rezero


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every conv and linear layer uniform in +-1/sqrt(fan_in) (torch's
    default), the embeddings and relative embeddings normal as the
    references init them, the norms left at one and zero. The rezero gains,
    zero in the references' init, are drawn from [0.01, 0.02) so that every
    linear attention shapes the output: the attention is quadratic in its
    input, and a gain near 1 overflows the U-Net's deeper levels on random
    weights. Draws in ``model.modules()`` order; returns ``model``."""
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(module.weight)
            bound = fan_in ** -0.5
            for p in (module.weight, module.bias):
                if p is not None:
                    p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
        elif isinstance(module, nn.Embedding):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator)
                                * module.weight.shape[1] ** -0.5)
        elif isinstance(module, RelPosMultiHeadAttention) and module.window_size:
            for p in (module.emb_rel_k, module.emb_rel_v):
                p.copy_(torch.randn(p.shape, generator=generator)
                        * module.k_channels ** -0.5)
        elif isinstance(module, Rezero):
            module.g.copy_(0.01 + 0.01 * torch.rand(1, generator=generator))
    return model
