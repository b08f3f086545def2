"""Grad-TTS text encoder (phonemes -> mel-frame prior + log-durations).

The port's counterpart of ``tpu_speech/models/text_encoder.py:26-90``, with
the reference's module tree (Grad-TTS/model/text_encoder.py:281-326):
embedding (x sqrt(d)) -> ConvReluNorm prenet -> rel-pos window transformer
-> mu projection, plus a gradient-detached duration predictor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpu_speech_torch.nn.blocks import ConvReluNorm, DurationPredictor, RelPosTransformer
from tpu_speech_torch.ops.masks import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, n_feats: int, n_channels: int, filter_channels: int,
                 filter_channels_dp: int, n_heads: int, n_layers: int, kernel_size: int,
                 p_dropout: float, window_size: Optional[int] = None,
                 spk_emb_dim: int = 64, n_spks: int = 1):
        super().__init__()
        self.n_channels, self.n_spks = n_channels, n_spks
        width = n_channels + (spk_emb_dim if n_spks > 1 else 0)
        self.emb = nn.Embedding(n_vocab, n_channels)
        nn.init.normal_(self.emb.weight, 0.0, n_channels ** -0.5)
        self.prenet = ConvReluNorm(n_channels, n_channels, n_channels, kernel_size=5,
                                   n_layers=3, p_dropout=0.5)
        self.encoder = RelPosTransformer(width, filter_channels, n_heads, n_layers,
                                         kernel_size, p_dropout, window_size=window_size)
        self.proj_m = nn.Conv1d(width, n_feats, 1)
        self.proj_w = DurationPredictor(width, filter_channels_dp, kernel_size, p_dropout)

    def forward(self, x, x_lengths, spk=None):
        """x: (B, Tx) ids; x_lengths: (B,). Returns the reference's layout:
        mu (B, n_feats, Tx), logw (B, 1, Tx), x_mask (B, 1, Tx) float."""
        h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)
        x_mask = sequence_mask(x_lengths, x.shape[1]).unsqueeze(1).to(h.dtype)
        h = self.prenet(h, x_mask)
        if self.n_spks > 1:
            h = torch.cat([h, spk[:, :, None].expand(-1, -1, h.shape[-1])], dim=1)
        h = self.encoder(h, x_mask)
        mu = self.proj_m(h) * x_mask
        logw = self.proj_w(h.detach(), x_mask)
        return mu, logw, x_mask
