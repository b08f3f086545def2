"""ST2Vec config, waveform -> spec front end, and the encoder's features path.

Port of ``tpu_speech/models/spiral/st2vec.py``: ``ST2VecConfig:44`` (a
field-for-field twin), ``spiral_base_config:70``, ``wav_to_spec:157`` (the
float32, int16 and mu-law wire formats) and
``ST2VecEncoder.encode_features:125``, the path CTC finetuning and
transcription use.

Not ported yet: the pretraining towers (projector, predictor, teacher
shift, negatives, contrastive loss, EMA), which the pretrain step needs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from tpu_speech_torch.models.spiral.encoder import (
    ConvLayerCfg,
    ConvTransformerBlockCfg,
    FeatureEncoder,
    StreamingCfg,
    spiral_base_blocks,
)
from tpu_speech_torch.models.spiral.features import filterbank_features


@dataclasses.dataclass(frozen=True)
class ST2VecConfig:
    blocks: Tuple[ConvTransformerBlockCfg, ...]
    num_features: int = 128
    sample_rate: int = 16000
    projector_dim: int = 256
    predictor_convs: Tuple[ConvLayerCfg, ...] = (
        ConvLayerCfg(256, (5,), (1,), "bn", "relu", 0.0, bias=None),
        ConvLayerCfg(256, (5,), (1,), "bn", "relu", 0.0, bias=None),
    )
    n_negatives: int = 100
    logit_temp: float = 0.3
    shift_unit: int = 8
    max_shift: int = 16
    target_momentum: float = 0.995
    target_momentum_final: float = 1.0
    target_momentum_steps: int = 200000
    mask_prob: float = 0.5
    mask_length: int = 20
    mask_channel_prob: float = 0.4
    mask_channel_length: int = 20
    dither: float = 1e-5
    streaming: Optional[StreamingCfg] = None


def spiral_base_config(**overrides) -> ST2VecConfig:
    return ST2VecConfig(blocks=spiral_base_blocks(), **overrides)


def wav_to_spec(cfg: ST2VecConfig, wavs: torch.Tensor, wav_lens: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
    """Waveforms (B, N) -> (specs (B, T, F), spec_lens (B,)).

    uint8 is the mu-law wire format (inverse companding); any other integer
    dtype is int16 PCM, scaled by 1/32768 (exact: a power of two).
    """
    if cfg.streaming is not None:
        raise NotImplementedError("the streaming front end is not ported yet")
    if wavs.dtype == torch.uint8:
        mu = 255.0
        y = wavs.to(torch.float32) * (1.0 / 127.5) - 1.0
        wavs = torch.sign(y) * (1.0 / mu) * (
            torch.exp(y.abs() * math.log1p(mu)) - 1.0
        )
    elif not wavs.is_floating_point():
        wavs = wavs.to(torch.float32) * (1.0 / 32768.0)
    return filterbank_features(
        wavs, wav_lens, sample_rate=cfg.sample_rate, nfilt=cfg.num_features,
        dither=cfg.dither, training=training, generator=generator,
    )


class ST2VecEncoder(nn.Module):
    """The ST2Vec encoder as CTC finetuning uses it: the feature encoder only
    (the reference drops the pretraining modules, st2vec_model.py:318-327)."""

    def __init__(self, cfg: ST2VecConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = FeatureEncoder(
            cfg.blocks, cfg.num_features, streaming=cfg.streaming, device=device)

    @property
    def output_dim(self) -> int:
        return self.feature_encoder.output_dim

    def encode_features(self, specs, spec_lens):
        """features_only path (CTC finetune): encoder output, no projector."""
        return self.feature_encoder(specs, spec_lens)
