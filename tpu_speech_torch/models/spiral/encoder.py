"""SPIRAL FeatureEncoder: conv subsampling + transformer blocks.

Port of ``tpu_speech/models/spiral/encoder.py`` (config dataclasses
``:20-66``, ``spiral_base_blocks:70``, ``FeatureEncoder:113``). The config
dataclasses are field-for-field twins of the JAX ones, so a config built
here compares equal (``dataclasses.asdict``) to the one the JAX experiment
files build.

The modules sit in one interleaved ``block_modules`` list (convs of block 0,
transformer 0, convs of block 1, transformer 1, ...), which is the layout of
the reference state_dict (``feature_encoder.block_modules.{i}.conv.conv.weight``,
``feature_encoder.block_modules.{i}.layers.{j}...``).

Not ported yet: the streaming-trainable mode (``StreamingCfg`` is kept as a
config field; a FeatureEncoder given one raises) and the Projector, which
only the pretrain step uses.
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
    """Streaming-trainable encoder mode (see the JAX StreamingCfg); not
    ported yet."""

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


class FeatureEncoder(nn.Module):
    """specs (B, T, F) -> features (B, T', D) with per-conv length tracking."""

    def __init__(self, blocks: Tuple[ConvTransformerBlockCfg, ...],
                 in_features: int, streaming: Optional[StreamingCfg] = None,
                 device=None):
        super().__init__()
        if streaming is not None:
            raise NotImplementedError("the streaming encoder mode is not ported yet")
        mods = []
        ch = in_features
        for blk in blocks:
            for c in blk.conv_layers:
                mods.append(ConvNormAct(
                    ch, c.filters, c.kernel_size, c.stride, c.norm_type,
                    c.act_func, c.dropout, bias=c.bias, device=device))
                ch = c.filters
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
                    device=device))
        self.block_modules = nn.ModuleList(mods)
        self.output_dim = ch

    def forward(self, x, lens):
        pad_mask = create_pad_mask(lens, x.shape[1])
        for mod in self.block_modules:
            if isinstance(mod, ConvNormAct):
                x, lens, pad_mask = mod(x, lens, pad_mask)
            else:
                x = mod(x, pad_mask)
        return x, lens
