"""SPIRAL pretraining: the teacher-student step with the EMA teacher.

Port of ``tpu_speech/train/spiral.py``: ``make_pretrain_step:66`` at
``accum_steps=1`` and fp32 becomes ``pretrain_step``, and the host-side
``host_augment_batch:305`` and ``quantize_wire_int16:245`` are numpy twins
that give equal arrays from one seed.

One step, as the JAX one: wav -> spec for the clean branch (teacher) and the
perturbed branch (student), with train-mode dither; teacher shift and a
no-grad teacher encode in train mode; the student's masked encode;
per-frame negatives from the teacher's targets; InfoNCE; gradients (zeros for
parameters the forward did not reach, such as a layer layerdrop skipped:
JAX differentiates every leaf and optax moves every leaf); the optional
global-norm clip; the optimizer; then the EMA with the momentum of the step
count before the increment. BatchNorm running statistics update in the
student's forward.

The random sources are explicit: ``DropoutRng`` (host generator: attention
seeds and layerdrop; device generator: dither, dropout, negatives).

Not ported yet: ``bf16=True`` (mixed precision) and ``accum_steps > 1``
(gradient accumulation); both raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.masking import (
    apply_mask,
    gaussian_mask_emb,
    make_student_masks,
)
from tpu_speech_torch.models.spiral.st2vec import (
    ST2VecEncoder,
    contrastive_loss,
    draw_negative_indices,
    ema_update,
    gather_negatives,
    momentum_schedule,
    teacher_shift,
    wav_to_spec,
)
from tpu_speech_torch.train.optim import clip_by_global_norm


@dataclasses.dataclass
class SpiralPretrainState:
    """Student and teacher (one ``ST2VecEncoder(pretraining=True)``), the
    optimizer over the student's parameters, and the step count."""

    model: ST2VecEncoder
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_pretrain_state(model: ST2VecEncoder, make_opt) -> SpiralPretrainState:
    """``make_opt(params) -> optimizer`` receives the student's parameters."""
    model.train()
    return SpiralPretrainState(model, make_opt(model.student_parameters()))


def pretrain_step(state: SpiralPretrainState, batch: dict, rng: DropoutRng,
                  grad_clip: Optional[float] = None, bf16: bool = False,
                  accum_steps: int = 1,
                  neg_idx: Optional[torch.Tensor] = None) -> dict:
    """One update of ``state`` in place from a device batch (the dict of
    ``host_augment_batch`` as tensors on the model's device; ``shift_k`` and
    ``shift_r`` stay host ints). ``neg_idx`` (B, T', N) replaces the drawn
    negative indices (the parity tests pass JAX's). Returns the step's
    metrics: ``loss`` and ``accuracy`` (0-d device tensors), ``momentum``
    and ``lr`` (floats), and the transformer layers each tower ran."""
    if bf16:
        raise NotImplementedError("bf16 pretraining is not ported yet")
    if accum_steps != 1:
        raise NotImplementedError("accum_steps > 1 is not ported yet")
    model = state.model
    cfg = model.cfg
    emb = torch.tensor(gaussian_mask_emb(cfg.num_features), device=batch["wavs"].device)

    t_specs, t_lens = wav_to_spec(cfg, batch["wavs"], batch["wav_lens"],
                                  training=True, generator=rng.device)
    s_specs, s_lens = wav_to_spec(cfg, batch["p_wavs"], batch["p_wav_lens"],
                                  training=True, generator=rng.device)
    k, r = int(batch["shift_k"]), int(batch["shift_r"])
    with torch.no_grad():
        t_sh, t_lens_sh = teacher_shift(t_specs, t_lens, k, r, cfg.shift_unit,
                                        cfg.max_shift, emb)
        targets, _ = model.encode_teacher(t_sh, t_lens_sh, rng)
        # trim the k leading shifted frames -> aligned with the student frames
        targets = targets[:, k:k + s_specs.shape[1] // cfg.shift_unit]
    teacher_layers = model.target_feature_encoder.layers_run()

    s_specs = apply_mask(s_specs, batch["time_mask"], batch["chan_mask"], emb)
    pred, feat_lens = model.encode_student(s_specs, s_lens, rng)
    student_layers = model.feature_encoder.layers_run()

    t_out = pred.shape[1]
    valid = (torch.arange(t_out, device=pred.device)[None, :]
             < feat_lens[:, None]).to(pred.dtype)
    if neg_idx is None:
        neg_idx = draw_negative_indices(feat_lens, t_out, cfg.n_negatives, rng.device)
    negs = gather_negatives(targets, neg_idx)
    loss, acc = contrastive_loss(pred, targets, negs, valid, cfg.logit_temp)

    params = model.student_parameters()
    for p in params:
        p.grad = None
    loss.backward()
    for p in params:
        if p.grad is None:  # not reached by this forward (layerdrop)
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in params], grad_clip)
    lr = state.optimizer.step()
    m = momentum_schedule(state.step, cfg.target_momentum,
                          cfg.target_momentum_final, cfg.target_momentum_steps)
    ema_update(model, m)
    state.step += 1
    return {"loss": loss.detach(), "accuracy": acc.detach(), "momentum": m,
            "lr": lr, "teacher_layers": teacher_layers,
            "student_layers": student_layers}


def quantize_wire_int16(batch: dict) -> dict:
    """Re-encode float32 waveform leaves as int16 PCM for the host->device
    copy (``quantize_wire_int16:245``); ``wav_to_spec`` decodes exactly."""
    out = dict(batch)
    for k in ("wavs", "p_wavs"):
        if k in out and out[k].dtype == np.float32:
            out[k] = np.clip(np.rint(out[k] * 32768.0), -32768, 32767).astype(np.int16)
    return out


def host_augment_batch(cfg, wavs, wav_lens, p_wavs, p_wav_lens, spec_len: int,
                       rng: np.random.Generator,
                       shift_rng: Optional[np.random.Generator] = None) -> dict:
    """Host-side per-batch randomness: the student's span and channel masks
    and the teacher's shift amounts (``host_augment_batch:305``)."""
    hop = int(0.01 * cfg.sample_rate)
    spec_lens = np.ceil(np.asarray(p_wav_lens) / hop).astype(np.int32)
    time_mask, chan_mask = make_student_masks(
        len(wav_lens), spec_len, cfg.num_features, spec_lens,
        cfg.mask_prob, cfg.mask_length, cfg.mask_channel_prob,
        cfg.mask_channel_length, rng=rng,
    )
    if shift_rng is None:
        shift_rng = rng
    shift_k = int(shift_rng.integers(0, cfg.max_shift + 1))
    shift_r = int(shift_rng.integers(0, cfg.max_shift + 1))
    return {
        "wavs": wavs, "wav_lens": wav_lens,
        "p_wavs": p_wavs, "p_wav_lens": p_wav_lens,
        "time_mask": time_mask, "chan_mask": chan_mask,
        "shift_k": np.int32(shift_k), "shift_r": np.int32(shift_r),
    }


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (through pinned memory for a
    CUDA device, so the copy does not wait for the card); the shift amounts
    stay host ints (they pick slices, so the step needs them on the host)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k in ("shift_k", "shift_r"):
            out[k] = int(v)
            continue
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out
