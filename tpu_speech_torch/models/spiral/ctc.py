"""CTC decoder head, finetune model, CTC loss and encoder surgery for SPIRAL.

Port of ``tpu_speech/models/spiral/ctc.py`` (``ConvASRDecoder:30``,
``CTCFinetuneModel:82``, ``ctc_loss:135``, ``load_pretrained_encoder:272``):
the ST2Vec feature encoder followed by the conv decoder, returning log-probs
and their lengths. Parameter names follow the reference state_dict:
``encoder.feature_encoder.block_modules.*``, ``decoder.proj_upsampling.*``,
``decoder.conv_layers.{i}.*`` and the 1x1 vocab conv
``decoder.decoder_layers.0.weight`` of shape (V, C, 1).

In training mode the forward takes a ``DropoutRng`` for the encoder's and
decoder's dropouts. ``freeze_encoder`` runs the encoder under
``torch.no_grad()`` (still in training mode: dropout, layerdrop and BatchNorm
statistics as usual), the twin of the JAX ``stop_gradient`` gate.

A streaming-mode encoder (``ST2VecConfig.streaming``) implies a causal
decoder (``ctc.py:117-119``): the upsampling projection and the decoder convs
pad (k - 1, 0), so the whole specs -> log-probs path is chunk-incremental.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

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
                 upsample_dropout: float = 0.1, causal: bool = False, device=None):
        super().__init__()
        self.num_classes, self.blank_pos = num_classes, blank_pos
        ch = in_features
        self.proj_upsampling = None
        if upsample_rate is not None:
            self.proj_upsampling = ProjUpsampling(
                ch, upsample_filters, (5,), upsample_rate,
                norm_type=upsample_norm, act_func=upsample_act,
                dropout=upsample_dropout, causal=causal, device=device)
            ch = upsample_filters
        convs = []
        for c in conv_layers:
            convs.append(ConvNormAct(ch, c.filters, c.kernel_size, c.stride,
                                     c.norm_type, c.act_func, c.dropout,
                                     bias=c.bias, causal=causal, device=device))
            ch = c.filters
        self.conv_layers = nn.ModuleList(convs)
        self.decoder_layers = nn.ModuleList(
            [nn.Conv1d(ch, self.num_classes_with_blank, 1, device=device)])

    @property
    def num_classes_with_blank(self) -> int:
        if self.blank_pos == "after_vocab_last":
            return self.num_classes + 1
        return self.num_classes

    def forward(self, x, lens, rng=None):
        if self.proj_upsampling is not None:
            x, lens = self.proj_upsampling(x, lens, rng)
        pad_mask = create_pad_mask(lens, x.shape[1])
        for conv in self.conv_layers:
            x, lens, pad_mask = conv(x, lens, pad_mask, rng)
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
            upsample_dropout, causal=encoder_cfg.streaming is not None, device=device)

    @property
    def blank_idx(self) -> int:
        if self.blank_pos == "vocab_first":
            return 0
        if self.blank_pos == "after_vocab_last":
            return self.num_classes  # appended blank
        return self.num_classes - 1

    def forward(self, specs, spec_lens, rng=None, freeze_encoder: bool = False):
        if freeze_encoder:
            with torch.no_grad():
                feats, feat_lens = self.encoder.encode_features(specs, spec_lens, rng)
        else:
            feats, feat_lens = self.encoder.encode_features(specs, spec_lens, rng)
        return self.decoder(feats, feat_lens, rng)

    def init_weights(self, generator: torch.Generator) -> "CTCFinetuneModel":
        """Seeded random init at the JAX package's scales
        (``st2vec.init_weights_``); the 1x1 vocab conv is lecun-normal like
        a dense layer."""
        init_weights_(self, generator, unit_gain=(self.decoder.decoder_layers[0],))
        return self


def ctc_loss(log_probs, logit_lens, labels, label_lens, blank_idx: int, count=None):
    """Mean over the batch of the per-sequence CTC negative log-likelihood
    (``ctc_loss:135``: ``optax.ctc_loss`` then ``jnp.mean``; not torch's
    ``reduction="mean"``, which divides by the label lengths).

    log_probs (B, T, V); labels (B, L) padded past ``label_lens``. A sequence
    whose labels cannot fit its frames gets loss 0 and a zero gradient
    (``zero_infinity``): optax gives it a large finite value instead, torch's
    default an infinite loss and NaN gradients (ROADMAP Queue 3). ``count``
    replaces the batch size as the divisor (a data-parallel rank passes the
    global batch's)."""
    per_seq = F.ctc_loss(
        log_probs.float().transpose(0, 1), labels.long(), logit_lens.long(),
        label_lens.long(), blank=blank_idx, reduction="none", zero_infinity=True)
    return per_seq.mean() if count is None else per_seq.sum() / count


@torch.no_grad()
def load_pretrained_encoder(model: CTCFinetuneModel,
                            state_dict: Mapping[str, torch.Tensor],
                            use_teacher: bool = False) -> None:
    """Checkpoint surgery (``load_pretrained_encoder:272``): copy the feature
    encoder of a pretraining state_dict, ``feature_encoder.*`` (or the EMA
    teacher's ``target_feature_encoder.*`` with ``use_teacher``, when it has
    one), into ``model.encoder.feature_encoder``, strictly; the decoder keeps
    its weights. A Lightning checkpoint's ``state_dict`` is unwrapped and the
    task models' ``st2vec_encoder.`` / ``encoder.`` prefixes stripped, as
    ``compat/torch_spiral.py:148-158`` does."""
    if "state_dict" in state_dict and not torch.is_tensor(state_dict["state_dict"]):
        state_dict = state_dict["state_dict"]
    for prefix in ("st2vec_encoder.", "encoder."):
        if any(k.startswith(prefix) for k in state_dict):
            state_dict = {k[len(prefix):]: v for k, v in state_dict.items()
                          if k.startswith(prefix)}
            break
    src = "feature_encoder."
    if use_teacher and any(k.startswith("target_feature_encoder.") for k in state_dict):
        src = "target_feature_encoder."
    encoder = {k[len(src):]: v for k, v in state_dict.items() if k.startswith(src)}
    if not encoder:
        raise ValueError(f"no {src}* tensors in the pretraining state_dict")
    model.encoder.feature_encoder.load_state_dict(encoder, strict=True)
