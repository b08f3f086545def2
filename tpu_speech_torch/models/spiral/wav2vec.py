"""fairseq-style transformer encoder with convolutional positional embedding.

Port of ``tpu_speech/models/spiral/wav2vec.py`` (``ConvPositionalEmbedding:20``,
``MultiheadSelfAttention:112``, ``TransformerSentenceEncoderLayer:220``,
``TransformerEncoder:274``). Layout (B, T, C); parameter names follow the
reference state_dict (``pos_conv.0.weight_v``, ``layers.{j}.self_attn.q_proj``,
``layers.{j}.fc1``, ``layer_norm``). The transformer LayerNorms use flax's
default epsilon 1e-6 (not torch's 1e-5).

The score/softmax/dropout/value chain of every layer runs through
``ops/fused_attention.py::fused_qkv_self_attention`` (the K2 kernels on
CUDA, forward and backward), and the positional conv through
``ops/fused_posconv.py::grouped_conv1d`` (the K4 kernel on CUDA, forward and
dx).

Training mode draws from an explicit ``DropoutRng`` passed to ``forward``:
one attention-dropout seed per layer per step and the layerdrop keep draws
on the host, the other dropout masks on the device. A layer that layerdrop
skips is not run (its parameters then get no gradient from this forward;
the pretrain step gives them zeros, as JAX's ``jnp.where`` does).

Under the steps' bf16 mixed precision the parameters arrive as bf16 copies
(``torch.func.functional_call``): the positional conv's weight norm runs in
the parameters' dtype and the merged qkv plane is in x's dtype, as in the
JAX module (``wav2vec.py:50-51,69,155``).

The streaming-trainable mode (``TransformerEncoder(causal_pos=True,
attn_chunk=C, attn_left_chunks=L)``, ``wav2vec.py:289-310``): the positional
conv is K4 with ``left_pad = K - 1`` (causal), and every layer carries the
block-chunked mask of ``chunked_attention_mask``. With a structured mask the
attention runs as plain torch ops, as the JAX module runs it outside any
Pallas kernel (``wav2vec.py:165-167, 193-216``): scores filled with -1e9
where the mask forbids, then the key-padding fill, softmax and dropout.
Without one every layer keeps K2.

Under the seq axis (``parallel/seq.py``) x holds a rank's frames: the
positional conv and each layer's attention gather their operand along time
(the (B, T, 3E) qkv plane for K2, with the whole key mask), run the kernel
on the whole T, and keep the rank's frames; the backward reduce-scatters
the operand's gradient along time. Everything else acts frame by frame.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.models.spiral.dropout import dropout
from tpu_speech_torch.ops.fused_attention import fused_qkv_self_attention
from tpu_speech_torch.ops.fused_posconv import grouped_conv1d
from tpu_speech_torch.parallel import seq as seq_axis

TRANSFORMER_LN_EPS = 1e-6  # flax nn.LayerNorm default (wav2vec.py:242-331)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv (k=128, g=16) with weight norm over (in/g, out) per tap,
    SamePad trim for an even kernel, and exact GELU (wav2vec.py:20-79). The
    conv is ``grouped_conv1d`` with left pad k // 2 (SAME-even + trim), on
    (B, T, C) as it comes.

    ``weight_v`` (C, C/g, k) and ``weight_g`` (1, 1, k) are plain parameters
    in the reference's weight_norm(dim=2) layout; the weight is computed in
    ``forward`` as v / max(||v||, 1e-12) * g with one norm per tap.

    ``causal=True`` pads (k - 1, 0): frame t sees frames t - k + 1 .. t.
    """

    def __init__(self, embedding_dim: int, conv_pos: int = 128,
                 conv_pos_groups: int = 16, causal: bool = False, device=None):
        super().__init__()
        c, k, g = embedding_dim, conv_pos, conv_pos_groups
        self.kernel_size, self.groups = k, g
        self.left_pad = k - 1 if causal else k // 2
        self.weight_v = nn.Parameter(torch.empty(c, c // g, k, device=device))
        self.weight_g = nn.Parameter(torch.empty(1, 1, k, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.reset_parameters()

    def init_std(self) -> float:
        """std of the reference init, sqrt(4 / (k * C))."""
        return math.sqrt(4.0 / (self.kernel_size * self.weight_v.shape[0]))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The reference init (wav2vec.py:38-49) from the global generator:
        direction normal(0, init_std), magnitude its per-tap norm, zero
        bias."""
        nn.init.normal_(self.weight_v, 0.0, self.init_std())
        self.weight_g.copy_(self.weight_v.square().sum(dim=(0, 1), keepdim=True).sqrt())
        self.bias.zero_()

    def weight(self) -> torch.Tensor:
        """The conv weight (C, C/g, k): v / max(||v||, 1e-12) * g, in the
        parameters' dtype."""
        v = self.weight_v
        norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
        return v / norm.clamp_min(1e-12) * self.weight_g

    def forward(self, x):
        seq = seq_axis.current()
        if seq is not None:  # K4 on the whole time axis, then this rank's frames
            x = seq_axis.gather_time(x, seq)
        y = grouped_conv1d(x, self.weight().to(x.dtype), self.groups, self.left_pad)
        if seq is not None:
            y = seq_axis.keep_frames(y, seq)
        return F.gelu(y + self.bias.to(x.dtype))


def chunked_attention_mask(t: int, chunk: int, left_chunks: int,
                           device=None) -> torch.Tensor:
    """(T, T) bool, True where attention is ALLOWED under block-chunked
    streaming (``wav2vec.py:82-92``): frames of chunk j attend to every frame
    of chunks j - left_chunks .. j."""
    cj = torch.arange(t, device=device) // chunk
    diff = cj[:, None] - cj[None, :]
    return (diff >= 0) & (diff <= left_chunks)


def masked_attention(qkv, n_heads: int, attn_mask, key_padding_mask=None,
                     dropout_p: float = 0.0, training: bool = False, rng=None):
    """Self-attention over the merged (B, T, 3E) plane under a (T, T)
    structured mask (True = allowed), as plain torch ops in qkv's dtype
    (``wav2vec.py:193-216``): scores -1e9 where ``attn_mask`` forbids, then
    -1e9 at padded keys, softmax, flax dropout from ``rng``, values."""
    b, t, e3 = qkv.shape
    e = e3 // 3
    q, k, v = qkv.view(b, t, 3, n_heads, e // n_heads).unbind(2)
    allowed = attn_mask[None, None]
    if key_padding_mask is not None:
        allowed = allowed & ~key_padding_mask[:, None, None, :]
    return attend(q, k, v, allowed, dropout_p, training, rng).reshape(b, t, e)


def attend(q, k, v, allowed, dropout_p: float = 0.0, training: bool = False, rng=None):
    """Plain softmax attention of q (B, T, H, D) over k, v (B, S, H, D):
    scores -1e9 where ``allowed`` (broadcast to (B, H, T, S)) is False,
    softmax, flax dropout from ``rng``, values; (B, T, H, D)."""
    scores = torch.einsum("bthd,bshd->bhts", q, k).masked_fill(~allowed, -1e9)
    p = dropout(torch.softmax(scores, dim=-1), dropout_p, training, rng)
    return torch.einsum("bhts,bshd->bthd", p, v)


class MultiheadSelfAttention(nn.Module):
    """Softmax MHA with q/k/v/out projections (fairseq layout).

    The q/k/v projections run as ONE (E, 3E) product whose q third carries
    the d_head**-0.5 scale in both weight and bias (wav2vec.py:148-155); the
    merged (B, T, 3E) plane goes to the K2 kernel as it is, or with an
    ``attn_mask`` to ``masked_attention``.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim, device=device))

    def qkv_weights(self):
        """(w (3E, E), b (3E,)) of the merged projection, the q third
        scaled by d_head**-0.5."""
        scale = (self.embed_dim // self.num_heads) ** -0.5
        w = torch.cat([self.q_proj.weight * scale, self.k_proj.weight,
                       self.v_proj.weight], dim=0)
        b = torch.cat([self.q_proj.bias * scale, self.k_proj.bias,
                       self.v_proj.bias], dim=0)
        return w, b

    def forward(self, x, key_padding_mask=None, rng=None, attn_mask=None):
        w, b = self.qkv_weights()
        qkv = F.linear(x, w.to(x.dtype), b.to(x.dtype))  # in x's dtype (wav2vec.py:155)
        if attn_mask is not None:
            return self.out_proj(masked_attention(
                qkv, self.num_heads, attn_mask, key_padding_mask, self.dropout,
                self.training, rng))
        drop_p, seed, b0 = 0.0, None, 0
        if self.training and self.dropout > 0.0:
            if rng is None:
                raise ValueError("training-mode attention dropout needs a DropoutRng")
            drop_p, seed, b0 = self.dropout, rng.attention_seed(), rng.row0
        seq = seq_axis.current()
        if seq is not None:  # K2 on the whole time axis (the key mask is whole already)
            qkv = seq_axis.gather_time(qkv, seq)
        out = fused_qkv_self_attention(qkv, self.num_heads, key_padding_mask,
                                       drop_p, seed, b0)
        if seq is not None:
            out = seq_axis.keep_frames(out, seq)
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
        self.dropout, self.activation_dropout = dropout, activation_dropout

    def forward(self, x, key_padding_mask=None, rng=None, attn_mask=None):
        def drop(v, p):
            return dropout(v, p, self.training, rng)

        if self.layer_norm_first:
            h = self.self_attn(self.self_attn_layer_norm(x), key_padding_mask, rng, attn_mask)
            x = x + drop(h, self.dropout)
            h = drop(self.act(self.fc1(self.final_layer_norm(x))), self.activation_dropout)
            return x + drop(self.fc2(h), self.dropout)
        h = self.self_attn(x, key_padding_mask, rng, attn_mask)
        x = self.self_attn_layer_norm(x + drop(h, self.dropout))
        h = drop(self.act(self.fc1(x)), self.activation_dropout)
        return self.final_layer_norm(x + drop(self.fc2(h), self.dropout))


class TransformerEncoder(nn.Module):
    """Conv-pos embedding + layer stack (wav2vec.py:274-332). Padded frames
    are zeroed before the positional conv. ``causal_pos`` and ``attn_chunk``
    (with ``attn_left_chunks``) are the streaming-trainable mode."""

    def __init__(self, embedding_dim: int, encoder_layers: int,
                 ffn_embedding_dim: int, num_attention_heads: int,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 activation_dropout: float = 0.0, activation_fn: str = "gelu",
                 layer_norm_first: bool = True,
                 encoder_layerdrop: float = 0.0, conv_pos: int = 128,
                 conv_pos_groups: int = 16, causal_pos: bool = False,
                 attn_chunk: Optional[int] = None, attn_left_chunks: int = 1,
                 device=None):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.encoder_layerdrop = encoder_layerdrop
        self.attn_chunk, self.attn_left_chunks = attn_chunk, attn_left_chunks
        # a one-element list keeps the reference name pos_conv.0.*
        self.pos_conv = nn.ModuleList([ConvPositionalEmbedding(
            embedding_dim, conv_pos, conv_pos_groups, causal_pos, device=device)])
        self.layers = nn.ModuleList([
            TransformerSentenceEncoderLayer(
                embedding_dim, ffn_embedding_dim, num_attention_heads,
                dropout, attention_dropout, activation_dropout, activation_fn,
                layer_norm_first, device=device)
            for _ in range(encoder_layers)
        ])
        self.layer_norm = nn.LayerNorm(embedding_dim, eps=TRANSFORMER_LN_EPS,
                                       device=device)
        self.dropout = dropout
        self.layers_run = 0  # layers the last forward ran (layerdrop skips)

    def forward(self, x, padding_mask=None, rng=None):
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[:, :, None], 0.0)
        key_mask = padding_mask
        if seq_axis.current() is not None:
            if self.attn_chunk is not None:
                raise ValueError("the seq axis takes no streaming-mode encoder")
            if padding_mask is not None:  # the attention reads every frame's mask
                key_mask = seq_axis.gather_frames(padding_mask)
        x = x + self.pos_conv[0](x)
        attn_mask = None
        if self.attn_chunk is not None:
            attn_mask = chunked_attention_mask(x.shape[1], self.attn_chunk,
                                               self.attn_left_chunks, x.device)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        x = dropout(x, self.dropout, self.training, rng)
        layerdrop = self.training and self.encoder_layerdrop > 0
        if layerdrop and rng is None:
            raise ValueError("training-mode layerdrop needs a DropoutRng")
        self.layers_run = 0
        for layer in self.layers:
            if layerdrop and not rng.keep_layer(self.encoder_layerdrop):
                continue
            x = layer(x, key_mask, rng, attn_mask)
            self.layers_run += 1
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return x
