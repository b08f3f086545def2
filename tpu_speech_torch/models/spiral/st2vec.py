"""ST2Vec: config, waveform -> spec front end, the encoder towers and the
pretraining pieces.

Port of ``tpu_speech/models/spiral/st2vec.py``: ``ST2VecConfig:44`` (a
field-for-field twin), ``spiral_base_config:70``, ``spiral_large_config:74``,
``wav_to_spec:157`` (the float32, int16 and mu-law wire formats),
``ST2VecEncoder:93`` and the
pretraining functions ``ema_update:141``, ``momentum_schedule:150``,
``teacher_shift:192``, ``sample_negatives:224`` (split into an index draw and
a gather that takes the index array), ``check_collapse:240`` (the validation
diagnostics) and ``contrastive_loss:286``.

``ST2VecEncoder(cfg)`` is the encoder as CTC finetuning uses it (feature
encoder only). ``ST2VecEncoder(cfg, pretraining=True)`` adds the student's
projector and predictor and the EMA teacher towers under the reference
state_dict names ``target_feature_encoder.*`` / ``target_projector.*``, which
``tpu_speech/compat/torch_spiral.py::convert_st2vec`` reads. The teacher's
parameters do not require gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_speech_torch.models.spiral.encoder import (
    ConvLayerCfg,
    ConvTransformerBlockCfg,
    FeatureEncoder,
    Projector,
    StreamingCfg,
    spiral_base_blocks,
    spiral_large_blocks,
)
from tpu_speech_torch.models.spiral.wav2vec import ConvPositionalEmbedding
from tpu_speech_torch.models.spiral.features import filterbank_features
from tpu_speech_torch.parallel.mesh import locals_


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


def spiral_large_config(**overrides) -> ST2VecConfig:
    """SPIRAL-large (spiral_large_pretrain_librilight.py:36-158): 1024-d
    encoder, 512-d projector and predictor, EMA momentum 0.99 -> 0.999."""
    kw = dict(
        blocks=spiral_large_blocks(),
        projector_dim=512,
        predictor_convs=(
            ConvLayerCfg(512, (5,), (1,), "bn", "relu", 0.0, bias=None),
            ConvLayerCfg(512, (5,), (1,), "bn", "relu", 0.0, bias=None),
        ),
        target_momentum=0.99,
        target_momentum_final=0.999,
    )
    kw.update(overrides)
    return ST2VecConfig(**kw)


def wav_to_spec(cfg: ST2VecConfig, wavs: torch.Tensor, wav_lens: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
    """Waveforms (B, N) -> (specs (B, T, F), spec_lens (B,)).

    uint8 is the mu-law wire format (inverse companding); any other integer
    dtype is int16 PCM, scaled by 1/32768 (exact: a power of two). A
    streaming-mode config (``st2vec.py:175-183``) normalizes each frame by
    the statistics of frames 0..t (``per_feature_causal``) and skips the
    utterance-wide time-domain peak normalization: it trains as the chunk
    step serves.
    """
    if wavs.dtype == torch.uint8:
        mu = 255.0
        y = wavs.to(torch.float32) * (1.0 / 127.5) - 1.0
        wavs = torch.sign(y) * (1.0 / mu) * (
            torch.exp(y.abs() * math.log1p(mu)) - 1.0
        )
    elif not wavs.is_floating_point():
        wavs = wavs.to(torch.float32) * (1.0 / 32768.0)
    stream = {} if cfg.streaming is None else dict(
        normalize="per_feature_causal", do_normalize_time_domain=False)
    return filterbank_features(
        wavs, wav_lens, sample_rate=cfg.sample_rate, nfilt=cfg.num_features,
        dither=cfg.dither, training=training, generator=generator, **stream,
    )


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator,
                  unit_gain: Tuple[nn.Module, ...] = ()) -> None:
    """Seeded random init at the JAX package's scales: kaiming-normal convs
    (lecun-normal for the modules in ``unit_gain``), lecun-normal linears,
    normal(0, sqrt(4/(k*C))) positional-conv direction with its per-tap norm
    as magnitude, zero biases, unit norms. Draws on the CPU generator, so
    build on the CPU and move the module afterwards."""

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for mod in module.modules():
        if isinstance(mod, ConvPositionalEmbedding):
            normal_(mod.weight_v, mod.init_std())
            mod.weight_g.copy_(
                mod.weight_v.square().sum(dim=(0, 1), keepdim=True).sqrt())
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv1d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            gain = 1.0 if (mod in unit_gain or isinstance(mod, nn.Linear)) else 2.0
            normal_(mod.weight, math.sqrt(gain / fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            mod.reset_parameters()


class ST2VecEncoder(nn.Module):
    """Student tower: feature encoder -> projector -> predictor; the EMA
    teacher tower: target feature encoder -> target projector.

    Without ``pretraining`` only the feature encoder exists (the reference
    drops the pretraining modules for finetuning, st2vec_model.py:318-327).
    """

    def __init__(self, cfg: ST2VecConfig, pretraining: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.pretraining = pretraining
        self.feature_encoder = FeatureEncoder(
            cfg.blocks, cfg.num_features, streaming=cfg.streaming, device=device)
        if not pretraining:
            return
        d, pd = self.feature_encoder.output_dim, cfg.projector_dim
        self.projector = Projector(d, (), pd, device=device)
        self.predictor = Projector(pd, cfg.predictor_convs, pd, device=device)
        self.target_feature_encoder = FeatureEncoder(
            cfg.blocks, cfg.num_features, streaming=cfg.streaming, device=device)
        self.target_projector = Projector(d, (), pd, device=device)
        for p in self.teacher_parameters():
            p.requires_grad_(False)

    @property
    def output_dim(self) -> int:
        return self.feature_encoder.output_dim

    def _pairs(self):
        """(teacher module, student module) the EMA mirrors."""
        return ((self.target_feature_encoder, self.feature_encoder),
                (self.target_projector, self.projector))

    def teacher_parameters(self):
        return [p for t, _ in self._pairs() for p in t.parameters()]

    def student_parameters(self):
        """Every parameter except the teacher's: what the optimizer moves."""
        teacher = {id(p) for p in self.teacher_parameters()} if self.pretraining else set()
        return [p for p in self.parameters() if id(p) not in teacher]

    @torch.no_grad()
    def copy_student_to_teacher(self) -> None:
        """The teacher starts as a copy of the student subset (the JAX
        ``init_spiral_state``)."""
        for t, s in self._pairs():
            t.load_state_dict(s.state_dict())

    def init_weights(self, generator: torch.Generator) -> "ST2VecEncoder":
        """Seeded init of the student (``init_weights_``); the teacher copies
        it."""
        init_weights_(self, generator)
        if self.pretraining:
            self.copy_student_to_teacher()
        return self

    def encode_features(self, specs, spec_lens, rng=None):
        """features_only path (CTC finetune): encoder output, no projector."""
        return self.feature_encoder(specs, spec_lens, rng)

    def encode_student(self, specs, spec_lens, rng=None):
        feats, feat_lens = self.feature_encoder(specs, spec_lens, rng)
        proj = self.projector(feats, feat_lens, rng)
        return self.predictor(proj, feat_lens, rng), feat_lens

    def encode_teacher(self, specs, spec_lens, rng=None):
        feats, feat_lens = self.target_feature_encoder(specs, spec_lens, rng)
        return self.target_projector(feats, feat_lens, rng), feat_lens

    def forward(self, specs, spec_lens, rng=None, tower: str = "student"):
        """One tower, ``student`` (``encode_student``) or ``teacher``
        (``encode_teacher``): the entry ``torch.func.functional_call``
        reaches, as the pretrain step's bf16 parameter copies do."""
        encode = self.encode_teacher if tower == "teacher" else self.encode_student
        return encode(specs, spec_lens, rng)


@torch.no_grad()
def ema_update(model: ST2VecEncoder, momentum: float) -> None:
    """teacher <- m * teacher + (1 - m) * student, in place (``ema_update:141``);
    shard by shard under FSDP (the two towers' leaves share their placement)."""
    teacher = locals_(model.teacher_parameters())
    student = locals_(p for _, s in model._pairs() for p in s.parameters())
    torch._foreach_mul_(teacher, momentum)
    torch._foreach_add_(teacher, student, alpha=1.0 - momentum)


def momentum_schedule(step: int, base: float, final: float, max_steps: int) -> float:
    """Cosine EMA momentum at ``step`` (``momentum_schedule:150``), in
    float32 as the JAX package computes it."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    return float(f32(final) + f32(0.5) * (f32(base) - f32(final))
                 * (f32(1) + np.cos(f32(np.pi) * frac)))


def teacher_shift(specs, spec_lens, k_units: int, r_units: int, unit: int,
                  max_units: int, mask_emb):
    """Shift the clean specs right by k units and extend them by r units,
    filling the introduced frames with the mask embedding; static output
    length T + 2 * max_units * unit (RandomShift.shift,
    st2vec_model.py:443-485). ``k_units``/``r_units`` are host ints."""
    b, t, f = specs.shape
    total = t + 2 * max_units * unit
    k, r = k_units * unit, r_units * unit
    buf = specs.new_zeros((b, total, f))
    buf[:, k:k + t] = specs
    new_lens = spec_lens + (k + r)
    pos = torch.arange(total, device=specs.device)[None, :]
    fill = (pos < k) | ((pos >= spec_lens[:, None] + k) & (pos < new_lens[:, None]))
    return torch.where(fill[:, :, None], mask_emb[None, None, :], buf), new_lens


def exclude_self(raw: torch.Tensor) -> torch.Tensor:
    """Uniform draws in [0, len - 1) per (b, t, n) -> frame indices that skip
    t itself, clamped to T - 1 (``sample_negatives:229-233``)."""
    t = raw.shape[1]
    pos = torch.arange(t, device=raw.device)[None, :, None]
    return torch.clamp(raw + (raw >= pos).to(raw.dtype), max=t - 1)


def draw_negative_indices(feat_lens, t: int, n_negatives: int,
                          generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, T, N) frame indices of the negatives, drawn on the lengths'
    device: uniform over the utterance's valid frames other than t."""
    b = feat_lens.shape[0]
    high = torch.clamp(feat_lens - 1, min=1).to(torch.int64)[:, None, None]
    u = torch.rand((b, t, n_negatives), generator=generator, device=feat_lens.device)
    raw = torch.minimum((u * high).to(torch.int64), high - 1)
    return exclude_self(raw)


def gather_negatives(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, T, D), idx (B, T, N) -> negatives (N, B, T, D)."""
    b = feats.shape[0]
    rows = torch.arange(b, device=feats.device)[:, None, None]
    return feats[rows, idx].permute(2, 0, 1, 3)


def check_collapse(pred, targets, feat_lens, trunc: int = 80) -> dict:
    """Representation-collapse diagnostics (``check_collapse:240``; the
    reference's st2vec_model.py:287-312 prints the matrices these reduce).
    Over the first ``min(min(feat_lens), trunc)`` frames, float32 0-d
    tensors: ``self_sim`` (mean off-diagonal cosine similarity of pred[0]
    with itself; a collapsed representation drives it toward 1),
    ``target_self_sim`` (the same for targets[0]), ``pred_target_sim`` (mean
    per-frame cos(pred[0], targets[0])) and, with B >= 2, ``cross_utt_sim``
    (mean per-frame cos(pred[0], pred[1]))."""
    t = min(trunc, pred.shape[1])
    n = torch.clamp(feat_lens.min(), max=t)
    frame_ok = (torch.arange(t, device=pred.device) < n).to(torch.float32)

    def unit(x):
        x = x.to(torch.float32)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)

    def offdiag_mean(u):
        w = frame_ok[:, None] * frame_ok[None, :] * (1.0 - torch.eye(t, device=u.device))
        return (u @ u.T * w).sum() / torch.clamp(w.sum(), min=1.0)

    def frame_mean(a, b):
        return ((a * b).sum(-1) * frame_ok).sum() / torch.clamp(frame_ok.sum(), min=1.0)

    p0, g0 = unit(pred[0, :t]), unit(targets[0, :t])
    out = {"self_sim": offdiag_mean(p0), "target_self_sim": offdiag_mean(g0),
           "pred_target_sim": frame_mean(p0, g0)}
    if pred.shape[0] >= 2:
        out["cross_utt_sim"] = frame_mean(p0, unit(pred[1, :t]))
    return out


def contrastive_loss(logits, targets, negatives, valid_mask, logit_temp: float,
                     count=None):
    """InfoNCE over cosine similarities (losses/wav2vecloss.py:55-128).

    logits/targets: (B, T, D); negatives: (N, B, T, D); valid_mask: (B, T)
    1.0 at valid frames. Returns (loss, accuracy) as 0-d tensors: sums over
    the valid frames divided by their count, or by ``count`` (a data-parallel
    rank passes the global batch's, so its loss is its piece of the global
    loss)."""
    neg_is_pos = (targets[None] == negatives).all(dim=-1)  # (N, B, T)
    cand = torch.cat([targets[None], negatives], dim=0)  # (1+N, B, T, D)
    a, c = logits[None].float(), cand.float()
    num = (a * c).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(c, dim=-1)
    sims = num / torch.clamp(den, min=1e-8) / logit_temp  # (1+N, B, T)
    sims = torch.cat([sims[:1], sims[1:].masked_fill(neg_is_pos, -1e9)], dim=0)
    ce = -torch.log_softmax(sims, dim=0)[0]  # (B, T)
    denom = torch.clamp(valid_mask.sum(), min=1.0) if count is None else count
    loss = (ce * valid_mask).sum() / denom
    arg, arg_min = sims.argmax(dim=0), sims.argmin(dim=0)
    correct = (arg == 0) & ~((arg == 0) & (arg_min == 0))
    acc = (correct.to(valid_mask.dtype) * valid_mask).sum() / denom
    return loss, acc
