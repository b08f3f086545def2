"""wav2vec 2.0: the pretraining model and its CTC wrapper.

Port of ``tpu_speech/models/spiral/wav2vec_model.py``: ``Wav2Vec2Config:39``
(a field-for-field twin; the defaults are wav2vec 2.0 BASE),
``wav2vec2_base_config:75``, ``grad_multiply:79`` (a
``torch.autograd.Function``), ``conv_subsampled_lens:96``,
``ConvFeatureEncoder:106``, ``Wav2Vec2Model:128`` with ``extract_features``,
``Wav2Vec2CTCModel:253`` and ``load_wav2vec_pretrained_encoder:294``.

Every tensor keeps its fixed (B, T, ...) shape, as in the JAX module: masked
frames are marked by the returned ``loss_weight``, and the codebook's
perplexity statistics are weighted by the same mask (where the reference
gathers the masked frames into a smaller batch). The transformer is the
port's post-LN ``TransformerEncoder`` (``layer_norm_first=False``): at BASE's
768 wide with 8 heads its attention runs the K2 kernels at d_head 96, and its
positional conv K4 at 48 channels a group.

State-dict names follow the reference's fairseq/NeMo wav2vec 2.0 modules:
``feature_extractor.conv_layers.{i}.0.weight`` (the conv),
``feature_extractor.conv_layers.0.2.{weight,bias}`` (the first layer's
GroupNorm, ``"default"`` mode) or ``feature_extractor.conv_layers.{i}.2.1.*``
(each layer's LayerNorm, ``"layer_norm"`` mode), ``layer_norm``,
``post_extract_proj``, ``mask_emb``, ``encoder.*`` (the SPIRAL transformer's
names), ``quantizer.vars``, ``quantizer.weight_proj``, ``project_q`` and
``final_proj``. ``tpu_speech/compat/`` has no wav2vec converter to follow;
``compat/jax_wav2vec.py`` maps the JAX trees onto these names.

The feature convs are channels-first inside (``F.conv1d``) and return
(B, T, C). GroupNorm (one group per channel, over every frame, epsilon 1e-5)
is ``F.group_norm``; the LayerNorms use flax's epsilon 1e-6. Training takes a
``DropoutRng`` for the dropouts and layerdrop, and the quantizer's Gumbel
noise as a tensor or from the rng's device generator.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.models.spiral.ctc import ConvASRDecoder
from tpu_speech_torch.models.spiral.dropout import dropout
from tpu_speech_torch.models.spiral.encoder import TransformerCfg
from tpu_speech_torch.models.spiral.quantizer import GumbelVectorQuantizer
from tpu_speech_torch.models.spiral.st2vec import init_weights_
from tpu_speech_torch.models.spiral.wav2vec import TRANSFORMER_LN_EPS, TransformerEncoder


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Defaults = wav2vec 2.0 BASE (wav2vec_config.py:47-185)."""

    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2),
    )
    extractor_mode: str = "default"
    conv_bias: bool = False
    encoder: TransformerCfg = TransformerCfg(
        encoder_layers=12, embedding_dim=768, ffn_embedding_dim=3072,
        num_attention_heads=8, dropout=0.1, attention_dropout=0.1,
        activation_dropout=0.0, encoder_layerdrop=0.05,
        conv_pos=128, conv_pos_groups=16, layer_norm_first=False,
    )
    dropout_input: float = 0.1
    dropout_features: float = 0.1
    final_dim: int = 256
    logit_temp: float = 0.1
    n_negatives: int = 100
    feature_grad_mult: float = 0.1
    quantize_targets: bool = True
    latent_vars: int = 320
    latent_groups: int = 2
    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    mask_prob: float = 0.65
    mask_length: int = 10
    mask_channel_prob: float = 0.0
    mask_channel_length: int = 10
    prob_ppl_weight: float = 0.1
    feature_loss_weight: float = 0.0


def wav2vec2_base_config(**overrides) -> Wav2Vec2Config:
    return Wav2Vec2Config(**overrides)


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x in the forward; the gradient times ``scale`` in the backward."""
    return _GradMultiply.apply(x, scale)


def conv_subsampled_lens(cfg: Wav2Vec2Config, wav_lens):
    """Valid output frames of the unpadded conv stack: (n - k) // s + 1 per
    layer, floored at 0 (a tensor or a numpy array, as given)."""
    lens = wav_lens
    for _, k, s in cfg.conv_layers:
        lens = (lens - k) // s + 1
    return torch.clamp(lens, min=0) if torch.is_tensor(lens) else np.maximum(lens, 0)


class ConvFeatureEncoder(nn.Module):
    """Raw wav (B, S) -> frame features (B, T, C): strided valid convs, the
    first layer's GroupNorm (``"default"``) or a LayerNorm after each
    (``"layer_norm"``), exact GELU."""

    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        if cfg.extractor_mode not in ("default", "layer_norm"):
            raise ValueError(f"extractor_mode {cfg.extractor_mode!r}")
        layers, ch = [], 1
        for i, (dim, k, s) in enumerate(cfg.conv_layers):
            conv = nn.Conv1d(ch, dim, k, s, bias=cfg.conv_bias, device=device)
            if cfg.extractor_mode == "layer_norm":  # Sequential(TransposeLast, LayerNorm, TransposeLast)
                norm = nn.Sequential(nn.Identity(), nn.LayerNorm(dim, eps=TRANSFORMER_LN_EPS,
                                                                 device=device), nn.Identity())
            elif i == 0:
                norm = nn.GroupNorm(dim, dim, eps=1e-5, device=device)
            else:
                norm = nn.Identity()
            # the reference's Sequential(conv, dropout, norm, GELU): names .0 and .2
            layers.append(nn.Sequential(conv, nn.Identity(), norm, nn.GELU()))
            ch = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wavs):
        x = wavs[:, None, :]
        for layer in self.conv_layers:
            conv, _, norm, _ = layer
            x = F.conv1d(x, conv.weight, conv.bias, conv.stride)
            if isinstance(norm, nn.GroupNorm):  # in float32, rounded once (flax's bf16)
                x = F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                                 norm.bias.float(), norm.eps).to(x.dtype)
            elif isinstance(norm, nn.Sequential):
                x = norm[1](x.transpose(1, 2)).transpose(1, 2)
            x = F.gelu(x)
        return x.transpose(1, 2)


def _linear_promoted(linear: nn.Linear, x):
    """``linear(x)`` in the promoted dtype of x and the weights, as a flax
    Dense computes it (a float32 input with bf16 weights runs in float32)."""
    dtype = torch.promote_types(x.dtype, linear.weight.dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), linear.bias.to(dtype))


class Wav2Vec2Model(nn.Module):
    """The pretraining forward (wav2vec_model.py:263-375): conv features,
    LayerNorm, projection, masking, the transformer; quantized targets from
    the unmasked features. ``pretraining=False`` leaves out the
    pretraining-only modules (quantizer, project_q, final_proj), as the
    reference's ``remove_pretraining_modules`` does for a downstream head.
    """

    def __init__(self, cfg: Wav2Vec2Config, pretraining: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder
        embed = cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureEncoder(cfg, device=device)
        self.layer_norm = nn.LayerNorm(embed, eps=TRANSFORMER_LN_EPS, device=device)
        self.post_extract_proj = (nn.Linear(embed, e.embedding_dim, device=device)
                                  if embed != e.embedding_dim else None)
        self.mask_emb = nn.Parameter(torch.rand(e.embedding_dim, device=device))
        self.encoder = TransformerEncoder(
            e.embedding_dim, e.encoder_layers, e.ffn_embedding_dim, e.num_attention_heads,
            e.dropout, e.attention_dropout, e.activation_dropout, e.activation_fn,
            e.layer_norm_first, e.encoder_layerdrop, e.conv_pos, e.conv_pos_groups,
            device=device)
        self.quantizer = self.project_q = self.final_proj = None
        if not pretraining:
            return
        if cfg.quantize_targets:
            self.quantizer = GumbelVectorQuantizer(
                embed, cfg.latent_vars, cfg.latent_groups, cfg.final_dim,
                temp=cfg.latent_temp, device=device)
        q_in = cfg.final_dim if cfg.quantize_targets else embed
        self.project_q = nn.Linear(q_in, cfg.final_dim, device=device)
        self.final_proj = nn.Linear(e.embedding_dim, cfg.final_dim, device=device)

    def forward(self, wavs, wav_lens, time_mask=None, num_updates: int = 0,
                features_only: bool = False, rng=None, gumbel=None):
        """wavs (B, S); time_mask (B, T) bool (the host's span mask; None: no
        masking). ``features_only``: (context, feat_lens); else a dict of
        logits, targets, feat_lens, loss_weight, features_penalty,
        prob_ppl_loss, cur_temp and prob_ppl."""
        c = self.cfg
        train = self.training
        features = self.feature_extractor(wavs)
        if c.feature_grad_mult <= 0:
            features = features.detach()
        elif c.feature_grad_mult != 1.0:
            features = grad_multiply(features, c.feature_grad_mult)
        feat_lens = conv_subsampled_lens(c, wav_lens)
        t = features.shape[1]
        valid = torch.arange(t, device=features.device)[None, :] < feat_lens[:, None]
        ff = features.float()
        features_penalty = (ff * valid[:, :, None]).square().sum() / torch.clamp(
            valid.sum() * features.shape[-1], min=1).float()

        features = self.layer_norm(features)
        unmasked = features
        if self.post_extract_proj is not None:
            features = self.post_extract_proj(features)
        features = dropout(features, c.dropout_input, train, rng)
        unmasked = dropout(unmasked, c.dropout_features, train, rng)
        x = features
        if time_mask is not None:
            x = torch.where(time_mask[:, :, None], self.mask_emb.to(features.dtype), features)
        context = self.encoder(x, ~valid, rng)
        if features_only:
            return context, feat_lens
        if self.final_proj is None:
            raise ValueError("the pretraining outputs need Wav2Vec2Model(pretraining=True)")

        weight = (time_mask & valid if time_mask is not None else valid).float()
        if self.quantizer is not None:
            targets, prob_ppl_loss, cur_temp, prob_ppl = self.quantizer(
                unmasked, num_updates, weight=weight, gumbel=gumbel,
                generator=None if rng is None else rng.device)
            targets = _linear_promoted(self.project_q, targets)
        else:
            targets = _linear_promoted(self.project_q, unmasked)
            zero = features.new_zeros((), dtype=torch.float32)
            prob_ppl_loss, cur_temp, prob_ppl = zero, 0.0, zero
        return {"logits": self.final_proj(context), "targets": targets,
                "feat_lens": feat_lens, "loss_weight": weight,
                "features_penalty": features_penalty, "prob_ppl_loss": prob_ppl_loss,
                "cur_temp": cur_temp, "prob_ppl": prob_ppl}

    def init_weights(self, generator: torch.Generator) -> "Wav2Vec2Model":
        """Seeded random init from a CPU generator (build on the CPU, then
        move): the port's SPIRAL scales (``st2vec.init_weights_``), GroupNorm
        and LayerNorm at 1 and 0, the mask embedding and the codebook
        uniform in [0, 1), the code logits' projection normal(0, 1) as the
        JAX module's ``weight_proj``."""
        init_weights_(self, generator)
        with torch.no_grad():
            self.mask_emb.copy_(torch.rand(self.mask_emb.shape, generator=generator))
            for mod in self.modules():
                if isinstance(mod, nn.GroupNorm):
                    mod.reset_parameters()
            if self.quantizer is not None:
                q = self.quantizer
                q.vars.copy_(torch.rand(q.vars.shape, generator=generator))
                q.weight_proj.weight.copy_(torch.randn(q.weight_proj.weight.shape,
                                                       generator=generator))
        return self

    def extract_features(self, wavs, wav_lens, rng=None):
        """Contextual features (B, T, E) and their lengths for a downstream
        head; the pretraining-only modules are not run."""
        return self(wavs, wav_lens, features_only=True, rng=rng)

    def layers_run(self) -> int:
        return self.encoder.layers_run


class Wav2Vec2CTCModel(nn.Module):
    """The wav2vec 2.0 encoder and a conv CTC head (the reference's
    ctc_finetune_model.py:42-73): wavs -> log-probs. ``freeze_encoder`` runs
    the encoder without a graph, as the JAX ``stop_gradient`` gate."""

    def __init__(self, cfg: Wav2Vec2Config, num_classes: int,
                 blank_pos: str = "after_vocab_last", device=None):
        super().__init__()
        self.num_classes, self.blank_pos = num_classes, blank_pos
        self.encoder = Wav2Vec2Model(cfg, pretraining=False, device=device)
        self.decoder = ConvASRDecoder(cfg.encoder.embedding_dim, num_classes,
                                      blank_pos=blank_pos, device=device)

    @property
    def blank_idx(self) -> int:
        if self.blank_pos == "vocab_first":
            return 0
        if self.blank_pos == "after_vocab_last":
            return self.num_classes
        return self.num_classes - 1

    def forward(self, wavs, wav_lens, time_mask=None, freeze_encoder: bool = False, rng=None):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_encoder):
            ctx, feat_lens = self.encoder(wavs, wav_lens, time_mask=time_mask,
                                          features_only=True, rng=rng)
        return self.decoder(ctx, feat_lens, rng)


PRETRAINING_ONLY = ("quantizer.", "project_q.", "final_proj.")


@torch.no_grad()
def load_wav2vec_pretrained_encoder(model: Wav2Vec2CTCModel, state_dict) -> None:
    """Load a pretraining ``Wav2Vec2Model`` state_dict into the CTC model's
    encoder, strictly once the pretraining-only modules (quantizer,
    project_q, final_proj) are left out; the decoder keeps its weights
    (``load_wav2vec_pretrained_encoder:294``)."""
    encoder = {k: v for k, v in state_dict.items() if not k.startswith(PRETRAINING_ONLY)}
    model.encoder.load_state_dict(encoder, strict=True)
