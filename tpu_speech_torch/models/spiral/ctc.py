"""CTC decoder head + finetune model for SPIRAL (forward only).

Port of ``tpu_speech/models/spiral/ctc.py`` (``ConvASRDecoder:30``,
``CTCFinetuneModel:82``): the ST2Vec feature encoder followed by the conv
decoder, returning log-probs and their lengths. Parameter names follow the
reference state_dict: ``encoder.feature_encoder.block_modules.*``,
``decoder.proj_upsampling.*``, ``decoder.conv_layers.{i}.*`` and the 1x1
vocab conv ``decoder.decoder_layers.0.weight`` of shape (V, C, 1).

Not ported yet: ``ctc_loss``, ``make_finetune_step`` and
``load_pretrained_encoder`` (the training path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.models.spiral.conv_layers import (
    ConvNormAct,
    ProjUpsampling,
    create_pad_mask,
)
from tpu_speech_torch.models.spiral.encoder import ConvLayerCfg
from tpu_speech_torch.models.spiral.st2vec import (
    ST2VecConfig,
    ST2VecEncoder,
    init_weights_,
)

_DEFAULT_DECODER_CONVS = (
    ConvLayerCfg(512, (5,), (1,), None, "relu", 0.1),
    ConvLayerCfg(512, (5,), (1,), None, "relu", 0.1),
)


class ConvASRDecoder(nn.Module):
    """[ProjUpsampling] + conv stack + 1x1 projection to the vocab, then
    log-softmax."""

    def __init__(self, in_features: int, num_classes: int,
                 conv_layers: Tuple[ConvLayerCfg, ...] = _DEFAULT_DECODER_CONVS,
                 blank_pos: str = "vocab_first",
                 upsample_rate: Optional[int] = None,
                 upsample_filters: int = 512,
                 upsample_norm: Optional[str] = "ln",
                 upsample_act: Optional[str] = "relu",
                 upsample_dropout: float = 0.1, device=None):
        super().__init__()
        self.num_classes, self.blank_pos = num_classes, blank_pos
        ch = in_features
        self.proj_upsampling = None
        if upsample_rate is not None:
            self.proj_upsampling = ProjUpsampling(
                ch, upsample_filters, (5,), upsample_rate,
                norm_type=upsample_norm, act_func=upsample_act,
                dropout=upsample_dropout, device=device)
            ch = upsample_filters
        convs = []
        for c in conv_layers:
            convs.append(ConvNormAct(ch, c.filters, c.kernel_size, c.stride,
                                     c.norm_type, c.act_func, c.dropout,
                                     bias=c.bias, device=device))
            ch = c.filters
        self.conv_layers = nn.ModuleList(convs)
        self.decoder_layers = nn.ModuleList(
            [nn.Conv1d(ch, self.num_classes_with_blank, 1, device=device)])

    @property
    def num_classes_with_blank(self) -> int:
        if self.blank_pos == "after_vocab_last":
            return self.num_classes + 1
        return self.num_classes

    def forward(self, x, lens):
        if self.proj_upsampling is not None:
            x, lens = self.proj_upsampling(x, lens)
        pad_mask = create_pad_mask(lens, x.shape[1])
        for conv in self.conv_layers:
            x, lens, pad_mask = conv(x, lens, pad_mask)
        proj = self.decoder_layers[0]
        logits = F.linear(x, proj.weight[:, :, 0], proj.bias)
        return torch.log_softmax(logits, dim=-1), lens


class CTCFinetuneModel(nn.Module):
    """ST2Vec encoder (features only) + ConvASRDecoder: specs -> log-probs."""

    def __init__(self, encoder_cfg: ST2VecConfig, num_classes: int,
                 blank_pos: str = "vocab_first",
                 decoder_convs: Tuple[ConvLayerCfg, ...] = _DEFAULT_DECODER_CONVS,
                 upsample_rate: Optional[int] = None,
                 upsample_filters: int = 512,
                 upsample_norm: Optional[str] = "ln",
                 upsample_act: Optional[str] = "relu",
                 upsample_dropout: float = 0.1, device=None):
        super().__init__()
        self.num_classes, self.blank_pos = num_classes, blank_pos
        self.encoder = ST2VecEncoder(encoder_cfg, device=device)
        self.decoder = ConvASRDecoder(
            self.encoder.output_dim, num_classes, decoder_convs, blank_pos,
            upsample_rate, upsample_filters, upsample_norm, upsample_act,
            upsample_dropout, device=device)

    @property
    def blank_idx(self) -> int:
        if self.blank_pos == "vocab_first":
            return 0
        if self.blank_pos == "after_vocab_last":
            return self.num_classes  # appended blank
        return self.num_classes - 1

    def forward(self, specs, spec_lens):
        feats, feat_lens = self.encoder.encode_features(specs, spec_lens)
        return self.decoder(feats, feat_lens)

    def init_weights(self, generator: torch.Generator) -> "CTCFinetuneModel":
        """Seeded random init at the JAX package's scales
        (``st2vec.init_weights_``); the 1x1 vocab conv is lecun-normal like
        a dense layer."""
        init_weights_(self, generator, unit_gain=(self.decoder.decoder_layers[0],))
        return self
