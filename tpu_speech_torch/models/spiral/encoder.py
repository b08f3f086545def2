"""SPIRAL FeatureEncoder: conv subsampling + transformer blocks.

Port of ``tpu_speech/models/spiral/encoder.py`` (config dataclasses
``:20-66``, ``spiral_base_blocks:70``, ``spiral_large_blocks:93``,
``FeatureEncoder:113``). The config
dataclasses are field-for-field twins of the JAX ones, so a config built
here compares equal (``dataclasses.asdict``) to the one the JAX experiment
files build.

The modules sit in one interleaved ``block_modules`` list (convs of block 0,
transformer 0, convs of block 1, transformer 1, ...), which is the layout of
the reference state_dict (``feature_encoder.block_modules.{i}.conv.conv.weight``,
``feature_encoder.block_modules.{i}.layers.{j}...``).

``Projector`` (``encoder.py:185``) is the pretrain towers' head: a conv stack
(the predictor's BatchNorm convs) and ``output_proj``, under the reference
names ``conv_layers.{i}.*`` and ``output_proj.*``.

``FeatureEncoder(..., streaming=StreamingCfg(C, L))`` is the
streaming-trainable mode (``encoder.py:144-180``): causal convs, the causal
positional conv, and in each transformer block the chunked mask of
C / (the block's cumulative stride) frames with L chunks of left context. C
must divide by the total stride. An offline forward in this mode equals the
chunk-incremental step of ``models/spiral/streaming.py``.

Not ported yet: a Projector with a transformer (no SPIRAL config has one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from torch import nn

from tpu_speech_torch.models.spiral.conv_layers import ConvNormAct, create_pad_mask
from tpu_speech_torch.models.spiral.wav2vec import TransformerEncoder


@dataclasses.dataclass(frozen=True)
class ConvLayerCfg:
    filters: int
    kernel_size: Tuple[int, ...] = (5,)
    stride: Tuple[int, ...] = (1,)
    norm_type: Optional[str] = "ln"
    act_func: Optional[str] = "relu"
    dropout: float = 0.0
    bias: Optional[bool] = True


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    encoder_layers: int
    embedding_dim: int
    ffn_embedding_dim: int
    num_attention_heads: int
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    conv_pos: int = 128
    conv_pos_groups: int = 16
    layer_norm_first: bool = True
    activation_fn: str = "gelu"


@dataclasses.dataclass(frozen=True)
class ConvTransformerBlockCfg:
    conv_layers: Tuple[ConvLayerCfg, ...]
    transformer: Optional[TransformerCfg] = None


@dataclasses.dataclass(frozen=True)
class StreamingCfg:
    """Streaming-trainable encoder mode: ``chunk_frames`` input spec frames
    a chunk (a multiple of the encoder's total stride) and ``left_chunks``
    chunks of left attention context."""

    chunk_frames: int
    left_chunks: int = 2


def spiral_base_blocks() -> Tuple[ConvTransformerBlockCfg, ...]:
    """SPIRAL-base feature encoder (spiral_base_pretrain_ls960.py:48-111)."""
    return (
        ConvTransformerBlockCfg(
            conv_layers=(
                ConvLayerCfg(384, (5,), (2,), "ln", "relu", 0.1),
                ConvLayerCfg(512, (5,), (2,), "ln", "relu", 0.1),
                ConvLayerCfg(512, (1,), (1,), "ln", None, 0.0),
            ),
            transformer=TransformerCfg(2, 512, 2048, 8, 0.1, encoder_layerdrop=0.0),
        ),
        ConvTransformerBlockCfg(
            conv_layers=(
                ConvLayerCfg(1536, (5,), (2,), "ln", "relu", 0.1),
                ConvLayerCfg(768, (1,), (1,), "ln", None, 0.0),
            ),
            transformer=TransformerCfg(10, 768, 3072, 12, 0.1, encoder_layerdrop=0.05),
        ),
    )


def spiral_large_blocks() -> Tuple[ConvTransformerBlockCfg, ...]:
    """SPIRAL-large feature encoder (spiral_large_pretrain_librilight.py:49-113):
    convs 384/512 stride 2, 2 and a 512 1x1 before a 4-layer 512-wide
    transformer; a 2048 stride-2 conv and a 1024 1x1 before a 20-layer
    1024-wide transformer with 16 heads."""
    return (
        ConvTransformerBlockCfg(
            conv_layers=(
                ConvLayerCfg(384, (5,), (2,), "ln", "relu", 0.1),
                ConvLayerCfg(512, (5,), (2,), "ln", "relu", 0.1),
                ConvLayerCfg(512, (1,), (1,), "ln", None, 0.0),
            ),
            transformer=TransformerCfg(4, 512, 2048, 8, 0.1, encoder_layerdrop=0.05),
        ),
        ConvTransformerBlockCfg(
            conv_layers=(
                ConvLayerCfg(2048, (5,), (2,), "ln", "relu", 0.1),
                ConvLayerCfg(1024, (1,), (1,), "ln", None, 0.0),
            ),
            transformer=TransformerCfg(20, 1024, 4096, 16, 0.1, encoder_layerdrop=0.05),
        ),
    )


class FeatureEncoder(nn.Module):
    """specs (B, T, F) -> features (B, T', D) with per-conv length tracking."""

    def __init__(self, blocks: Tuple[ConvTransformerBlockCfg, ...],
                 in_features: int, streaming: Optional[StreamingCfg] = None,
                 device=None):
        super().__init__()
        self.streaming = streaming
        total = 1
        for blk in blocks:
            for c in blk.conv_layers:
                total *= c.stride[0]
        if streaming is not None and streaming.chunk_frames % total:
            raise ValueError(
                f"streaming chunk_frames {streaming.chunk_frames} must divide by the "
                f"encoder's total subsample factor ({total})")
        mods = []
        ch, cum = in_features, 1
        for blk in blocks:
            for c in blk.conv_layers:
                mods.append(ConvNormAct(
                    ch, c.filters, c.kernel_size, c.stride, c.norm_type,
                    c.act_func, c.dropout, bias=c.bias,
                    causal=streaming is not None, device=device))
                ch = c.filters
                cum *= c.stride[0]
            if blk.transformer is not None:
                t = blk.transformer
                if t.embedding_dim != ch:
                    raise ValueError(
                        f"transformer width {t.embedding_dim} != conv width {ch}")
                mods.append(TransformerEncoder(
                    t.embedding_dim, t.encoder_layers, t.ffn_embedding_dim,
                    t.num_attention_heads, t.dropout, t.attention_dropout,
                    t.activation_dropout, t.activation_fn, t.layer_norm_first,
                    t.encoder_layerdrop, t.conv_pos, t.conv_pos_groups,
                    causal_pos=streaming is not None,
                    attn_chunk=None if streaming is None else streaming.chunk_frames // cum,
                    attn_left_chunks=1 if streaming is None else streaming.left_chunks,
                    device=device))
        self.block_modules = nn.ModuleList(mods)
        self.output_dim = ch

    def forward(self, x, lens, rng=None):
        pad_mask = create_pad_mask(lens, x.shape[1])
        for mod in self.block_modules:
            if isinstance(mod, ConvNormAct):
                x, lens, pad_mask = mod(x, lens, pad_mask, rng)
            else:
                x = mod(x, pad_mask, rng)
        return x, lens

    def layers_run(self) -> int:
        """Transformer layers the last forward ran (layerdrop skips some)."""
        return sum(m.layers_run for m in self.block_modules
                   if isinstance(m, TransformerEncoder))


class Projector(nn.Module):
    """Optional conv stack + linear ``output_proj`` (spec2vec.py:128-185);
    the convs keep stride 1, so lengths pass through."""

    def __init__(self, in_dim: int, conv_layers: Tuple[ConvLayerCfg, ...],
                 output_dim: int, device=None):
        super().__init__()
        convs, ch = [], in_dim
        for c in conv_layers:
            if tuple(c.stride) != (1,):
                raise ValueError(f"projector convs keep stride 1: {c}")
            convs.append(ConvNormAct(ch, c.filters, c.kernel_size, c.stride,
                                     c.norm_type, c.act_func, c.dropout,
                                     bias=c.bias, device=device))
            ch = c.filters
        self.conv_layers = nn.ModuleList(convs)
        self.output_proj = nn.Linear(ch, output_dim, device=device)

    def forward(self, x, lens, rng=None):
        pad_mask = create_pad_mask(lens, x.shape[1])
        for conv in self.conv_layers:
            x, lens, pad_mask = conv(x, lens, pad_mask, rng)
        return self.output_proj(x)
