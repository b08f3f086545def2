"""fairseq-style transformer encoder with convolutional positional embedding.

Port of ``tpu_speech/models/spiral/wav2vec.py`` (``ConvPositionalEmbedding:20``,
``MultiheadSelfAttention:112``, ``TransformerSentenceEncoderLayer:220``,
``TransformerEncoder:274``). Layout (B, T, C); parameter names follow the
reference state_dict (``pos_conv.0.weight_v``, ``layers.{j}.self_attn.q_proj``,
``layers.{j}.fc1``, ``layer_norm``). The transformer LayerNorms use flax's
default epsilon 1e-6 (not torch's 1e-5).

The score/softmax/value chain of every layer runs through
``ops/fused_attention.py::fused_qkv_self_attention`` (the K2 kernel on CUDA).

Not ported yet: layerdrop and attention dropout in training (they need the
K2 backward/dropout kernel), the causal positional conv and chunked
attention of the streaming mode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.ops.fused_attention import fused_qkv_self_attention

TRANSFORMER_LN_EPS = 1e-6  # flax nn.LayerNorm default (wav2vec.py:242-331)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv (k=128, g=16) with weight norm over (in/g, out) per tap,
    SamePad trim for an even kernel, and exact GELU (wav2vec.py:20-79).

    ``weight_v`` (C, C/g, k) and ``weight_g`` (1, 1, k) are plain parameters
    in the reference's weight_norm(dim=2) layout; the weight is computed in
    ``forward`` as v / max(||v||, 1e-12) * g with one norm per tap.
    """

    def __init__(self, embedding_dim: int, conv_pos: int = 128,
                 conv_pos_groups: int = 16, device=None):
        super().__init__()
        c, k, g = embedding_dim, conv_pos, conv_pos_groups
        self.kernel_size, self.groups = k, g
        self.weight_v = nn.Parameter(torch.empty(c, c // g, k, device=device))
        self.weight_g = nn.Parameter(torch.empty(1, 1, k, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))

    def init_std(self) -> float:
        """std of the reference init, sqrt(4 / (k * C))."""
        return math.sqrt(4.0 / (self.kernel_size * self.weight_v.shape[0]))

    def forward(self, x):
        v = self.weight_v
        norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
        w = v / norm.clamp_min(1e-12) * self.weight_g
        k = self.kernel_size
        y = F.conv1d(x.transpose(1, 2), w, self.bias, padding=k // 2,
                     groups=self.groups)
        if k % 2 == 0:
            y = y[:, :, :-1]  # SamePad: an even kernel yields one extra frame
        return F.gelu(y.transpose(1, 2))


class MultiheadSelfAttention(nn.Module):
    """Softmax MHA with q/k/v/out projections (fairseq layout).

    The q/k/v projections run as ONE (E, 3E) product whose q third carries
    the d_head**-0.5 scale in both weight and bias (wav2vec.py:148-155); the
    merged (B, T, 3E) plane goes to the K2 kernel as it is.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim, device=device))

    def forward(self, x, key_padding_mask=None):
        scale = (self.embed_dim // self.num_heads) ** -0.5
        w = torch.cat([self.q_proj.weight * scale, self.k_proj.weight,
                       self.v_proj.weight], dim=0)
        b = torch.cat([self.q_proj.bias * scale, self.k_proj.bias,
                       self.v_proj.bias], dim=0)
        qkv = F.linear(x, w, b)
        out = fused_qkv_self_attention(
            qkv, self.num_heads, key_padding_mask,
            dropout_p=self.dropout if self.training else 0.0,
        )
        return self.out_proj(out)


class TransformerSentenceEncoderLayer(nn.Module):
    """Pre/post-LN transformer layer (wav2vec.py:220-271)."""

    def __init__(self, embedding_dim: int, ffn_embedding_dim: int,
                 num_attention_heads: int, dropout: float = 0.1,
                 attention_dropout: float = 0.1,
                 activation_dropout: float = 0.0,
                 activation_fn: str = "gelu", layer_norm_first: bool = True,
                 device=None):
        super().__init__()
        if activation_fn not in ("gelu", "relu"):
            raise NotImplementedError(f"activation_fn={activation_fn!r}")
        self.act = F.gelu if activation_fn == "gelu" else F.relu
        self.layer_norm_first = layer_norm_first
        self.self_attn = MultiheadSelfAttention(
            embedding_dim, num_attention_heads, attention_dropout, device=device)
        self.self_attn_layer_norm = nn.LayerNorm(
            embedding_dim, eps=TRANSFORMER_LN_EPS, device=device)
        self.fc1 = nn.Linear(embedding_dim, ffn_embedding_dim, device=device)
        self.fc2 = nn.Linear(ffn_embedding_dim, embedding_dim, device=device)
        self.final_layer_norm = nn.LayerNorm(
            embedding_dim, eps=TRANSFORMER_LN_EPS, device=device)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(activation_dropout)
        self.dropout3 = nn.Dropout(dropout)

    def forward(self, x, key_padding_mask=None):
        if self.layer_norm_first:
            h = self.self_attn(self.self_attn_layer_norm(x), key_padding_mask)
            x = x + self.dropout1(h)
            h = self.dropout2(self.act(self.fc1(self.final_layer_norm(x))))
            return x + self.dropout3(self.fc2(h))
        h = self.self_attn(x, key_padding_mask)
        x = self.self_attn_layer_norm(x + self.dropout1(h))
        h = self.dropout2(self.act(self.fc1(x)))
        return self.final_layer_norm(x + self.dropout3(self.fc2(h)))


class TransformerEncoder(nn.Module):
    """Conv-pos embedding + layer stack (wav2vec.py:274-332). Padded frames
    are zeroed before the positional conv."""

    def __init__(self, embedding_dim: int, encoder_layers: int,
                 ffn_embedding_dim: int, num_attention_heads: int,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 activation_dropout: float = 0.0, activation_fn: str = "gelu",
                 layer_norm_first: bool = True,
                 encoder_layerdrop: float = 0.0, conv_pos: int = 128,
                 conv_pos_groups: int = 16, device=None):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.encoder_layerdrop = encoder_layerdrop
        # a one-element list keeps the reference name pos_conv.0.*
        self.pos_conv = nn.ModuleList([ConvPositionalEmbedding(
            embedding_dim, conv_pos, conv_pos_groups, device=device)])
        self.layers = nn.ModuleList([
            TransformerSentenceEncoderLayer(
                embedding_dim, ffn_embedding_dim, num_attention_heads,
                dropout, attention_dropout, activation_dropout, activation_fn,
                layer_norm_first, device=device)
            for _ in range(encoder_layers)
        ])
        self.layer_norm = nn.LayerNorm(embedding_dim, eps=TRANSFORMER_LN_EPS,
                                       device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, padding_mask=None):
        if self.training and self.encoder_layerdrop > 0:
            raise NotImplementedError("layerdrop (training) is not ported yet")
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[:, :, None], 0.0)
        x = x + self.pos_conv[0](x)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        x = self.dropout(x)
        for layer in self.layers:
            x = layer(x, padding_mask)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return x
