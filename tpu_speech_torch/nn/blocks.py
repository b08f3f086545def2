"""Sequence-model building blocks (glow-tts family).

The port's counterpart of ``tpu_speech/nn/blocks.py:20-268``, laid out as the
reference Grad-TTS encoder stack (Grad-TTS/model/text_encoder.py:11-279):
channels-first (B, C, T) activations, which are cuDNN's, and the reference's
module and parameter names (``conv_q`` is a k=1 ``Conv1d``, LayerNorm holds
``gamma``/``beta``), so a reference ``state_dict`` loads as it is. Dropout
modules sit where the reference has them; serving runs in ``eval()``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel dim (dim 1), eps 1e-4 (text_encoder.py:11-29)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.channels, self.eps = channels, eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, 1, keepdim=True)
        variance = torch.mean((x - mean) ** 2, 1, keepdim=True)
        x = (x - mean) * torch.rsqrt(variance + self.eps)
        shape = [1, -1] + [1] * (x.dim() - 2)
        return x * self.gamma.view(*shape) + self.beta.view(*shape)


class ConvReluNorm(nn.Module):
    """Conv prenet with a zero-initialised residual projection (text_encoder.py:32-64)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int, n_layers: int, p_dropout: float):
        super().__init__()
        self.n_layers = n_layers
        self.conv_layers = nn.ModuleList()
        self.norm_layers = nn.ModuleList()
        for i in range(n_layers):
            self.conv_layers.append(nn.Conv1d(in_channels if i == 0 else hidden_channels,
                                              hidden_channels, kernel_size,
                                              padding=kernel_size // 2))
            self.norm_layers.append(ChannelLayerNorm(hidden_channels))
        self.relu_drop = nn.Sequential(nn.ReLU(), nn.Dropout(p_dropout))
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask):
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = self.relu_drop(norm(conv(x * x_mask)))
        return (x_org + self.proj(x)) * x_mask


class DurationPredictor(nn.Module):
    """Two conv layers and a projection to the log-duration (text_encoder.py:67-93)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size,
                                padding=kernel_size // 2)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size,
                                padding=kernel_size // 2)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask):
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask  # (B, 1, T)


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 2L-1) relative logits -> (B, H, L, L) absolute (pad-reshape trick)."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, length * 2 * length), (0, length - 1))
    return x_flat.reshape(b, h, length + 1, 2 * length - 1)[:, :, :length, length - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, L) absolute weights -> (B, H, L, 2L-1) relative."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1))
    x_flat = F.pad(x.reshape(b, h, length * length + length * (length - 1)), (length, 0))
    return x_flat.reshape(b, h, length, 2 * length)[:, :, :, 1:]


def _windowed_rel_emb(emb: torch.Tensor, window_size: int, length: int) -> torch.Tensor:
    """Slice/pad the (1, 2w+1, d) embedding table to (1, 2L-1, d)."""
    pad_length = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start:start + 2 * length - 1]


class RelPosMultiHeadAttention(nn.Module):
    """Multi-head self-attention with windowed relative position bias.

    The reference's ``MultiHeadAttention`` (text_encoder.py:96-215,
    heads_share=True): shared (1, 2w+1, d_head) key/value relative
    embeddings, mask fill -1e4.
    """

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = None, p_dropout: float = 0.0):
        super().__init__()
        assert channels % n_heads == 0
        self.n_heads, self.window_size = n_heads, window_size
        self.k_channels = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        if window_size is not None:
            rel_stddev = self.k_channels ** -0.5
            self.emb_rel_k = nn.Parameter(
                torch.randn(1, 2 * window_size + 1, self.k_channels) * rel_stddev)
            self.emb_rel_v = nn.Parameter(
                torch.randn(1, 2 * window_size + 1, self.k_channels) * rel_stddev)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        self.drop = nn.Dropout(p_dropout)
        for conv in (self.conv_q, self.conv_k, self.conv_v):
            nn.init.xavier_uniform_(conv.weight)

    def _heads(self, x):  # (B, C, T) -> (B, H, T, d)
        b, _, t = x.shape
        return x.view(b, self.n_heads, self.k_channels, t).transpose(2, 3)

    def forward(self, x, c, attn_mask=None):
        q, k, v = (self._heads(y) for y in (self.conv_q(x), self.conv_k(c), self.conv_v(c)))
        b, _, t_t, _ = q.shape
        t_s = k.shape[2]
        scale = math.sqrt(self.k_channels)
        scores = torch.matmul(q, k.transpose(-2, -1)) / scale
        if self.window_size is not None:
            assert t_s == t_t, "relative attention requires self-attention"
            key_rel = _windowed_rel_emb(self.emb_rel_k, self.window_size, t_s)
            rel_logits = torch.matmul(q, key_rel[0].transpose(0, 1))
            scores = scores + _rel_to_abs(rel_logits) / scale
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p_attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(p_attn, v)
        if self.window_size is not None:
            value_rel = _windowed_rel_emb(self.emb_rel_v, self.window_size, t_s)
            out = out + torch.matmul(_abs_to_rel(p_attn), value_rel[0])
        out = out.transpose(2, 3).reshape(b, -1, t_t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward (kernel 3 in Grad-TTS) with masking (text_encoder.py:218-239)."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size,
                                padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size,
                                padding=kernel_size // 2)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask):
        x = self.drop(torch.relu(self.conv_1(x * x_mask)))
        return self.conv_2(x * x_mask) * x_mask


class RelPosTransformer(nn.Module):
    """Post-norm transformer encoder with windowed rel-pos attention: the
    reference's ``Encoder`` (text_encoder.py:242-278)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 window_size: Optional[int] = None):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.attn_layers.append(RelPosMultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, window_size=window_size,
                p_dropout=p_dropout))
            self.norm_layers_1.append(ChannelLayerNorm(hidden_channels))
            self.ffn_layers.append(FFN(hidden_channels, hidden_channels, filter_channels,
                                       kernel_size, p_dropout=p_dropout))
            self.norm_layers_2.append(ChannelLayerNorm(hidden_channels))

    def forward(self, x, x_mask):
        # x: (B, C, T); x_mask: (B, 1, T)
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = x * x_mask
            x = norm1(x + self.drop(attn(x, x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask
