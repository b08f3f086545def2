"""Transformer-XL style relative-position attention (Conformer family).

Port of ``tpu_speech/nn/conformer_attention.py`` (``rel_positional_encoding:19``,
``_rel_shift:32``, ``RelPositionMultiHeadAttention:43``): the content and
position score decomposition with learned u/v biases
(https://arxiv.org/abs/1901.02860 §3.3), under NeMo's module names
(``linear_q``, ``linear_k``, ``linear_v``, ``linear_pos`` (no bias),
``linear_out``, ``pos_bias_u``, ``pos_bias_v``).

The attention is plain torch products, as JAX computes it with ``einsum``
(no Pallas kernel computes this function): the (B, H, T, 2T - 1) position
scores are materialised and shifted. Masked pairs get -1e9 before the
softmax and 0 after it; dropout acts on the attention weights.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.models.spiral.dropout import DropoutRng, dropout


def rel_positional_encoding(length: int, d_model: int) -> np.ndarray:
    """Sinusoidal embeddings for relative offsets length-1 .. -(length-1),
    shape (2*length - 1, d_model), float32 (computed in float64)."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * length - 1, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=16)
def rel_positional_table(length: int, d_model: int, device: torch.device) -> torch.Tensor:
    """``rel_positional_encoding`` on ``device``, copied once per (length,
    width, device). Shared by every call: read only."""
    with torch.inference_mode(False):  # a cached tensor outlives any inference region
        return torch.tensor(rel_positional_encoding(length, d_model), device=device)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) position scores -> (B, H, T, T) absolute alignment:
    flat pad by T, reshape to rows of 2T, truncate to T, flip (the
    reference's rel_shift, multi_head_attention.py:164-172)."""
    b, h, t, pos_len = x.shape
    x = F.pad(x.reshape(b, h, -1), (0, t))
    x = x.reshape(b, h, t, pos_len + 1)
    return torch.flip(x[:, :, :, :t], dims=(-1,))


class RelPositionMultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.n_head, self.n_feat, self.dropout_rate = n_head, n_feat, dropout_rate
        self.d_k = n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat, device=device)
        self.linear_k = nn.Linear(n_feat, n_feat, device=device)
        self.linear_v = nn.Linear(n_feat, n_feat, device=device)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False, device=device)
        self.linear_out = nn.Linear(n_feat, n_feat, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k, device=device))

    def forward(self, query, key, value, mask: Optional[torch.Tensor] = None,
                pos_emb: Optional[torch.Tensor] = None, rng: Optional[DropoutRng] = None):
        """query/key/value (B, T, F); mask (B, T, T) True at masked pairs;
        pos_emb (2T - 1, F) relative sinusoids (built when not given)."""
        b, t, _ = query.shape
        h, d_k = self.n_head, self.d_k
        if pos_emb is None:
            pos_emb = rel_positional_table(t, self.n_feat, query.device)
        q = self.linear_q(query).reshape(b, t, h, d_k)
        k = self.linear_k(key).reshape(b, -1, h, d_k).permute(0, 2, 3, 1)  # (B, H, D, S)
        v = self.linear_v(value).reshape(b, -1, h, d_k).transpose(1, 2)  # (B, H, S, D)
        p = self.linear_pos(pos_emb).reshape(-1, h, d_k).permute(1, 2, 0)  # (H, D, R)
        # content score: (q + u) . k; position score: (q + v) . p, shifted
        ac = torch.matmul((q + self.pos_bias_u).transpose(1, 2), k)
        bd = torch.matmul((q + self.pos_bias_v).transpose(1, 2), p)
        scores = (ac + _rel_shift(bd)) / math.sqrt(d_k)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None], -1e9)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(mask[:, None], 0.0)
        attn = dropout(attn, self.dropout_rate, self.training, rng)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, self.n_feat)
        return self.linear_out(out)
