"""SPIRAL pretraining: the teacher-student step with the EMA teacher.

Port of ``tpu_speech/train/spiral.py``: ``make_pretrain_step:66`` becomes
``pretrain_step``, with its bf16 mixed precision and its gradient
accumulation, and the host-side ``host_augment_batch:305`` and
``quantize_wire_int16:245`` are numpy twins that give equal arrays from one
seed.

``validation_loss`` is the no-update loss of the pretrain runner's
validation (train=False), with ``check_collapse`` on the same tensors.

One step, as the JAX one: wav -> spec for the clean branch (teacher) and the
perturbed branch (student), with train-mode dither; teacher shift and a
no-grad teacher encode in train mode; the student's masked encode;
per-frame negatives from the teacher's targets; InfoNCE; gradients (zeros for
parameters the forward did not reach, such as a layer layerdrop skipped:
JAX differentiates every leaf and optax moves every leaf); the optional
global-norm clip; the optimizer; then the EMA with the momentum of the step
count before the increment. BatchNorm running statistics update in the
student's forward.

Mixed precision (``bf16=True``, ``:100-130``): the optimizer keeps the
float32 master parameters; each micro-batch's forward runs on bf16 copies of
the student's and the teacher's parameters (``mixed_precision_params``, a
differentiable cast, so the gradients reach the masters in float32) through
``torch.func.functional_call``; the featurizer stays float32 and the specs
and the mask embedding are cast after it; buffers (BatchNorm statistics) stay
float32. It is not ``torch.autocast`` (which keeps norms and other ops in
float32 and casts per op) and not ``model.bfloat16()`` (which would lose the
masters).

Accumulation (``accum_steps > 1``, ``:183-205``): a list of micro-batch
dicts; each runs its forward and ``(loss / accum_steps).backward()``, so one
micro-batch's activations are alive at a time, and the BatchNorm statistics
move through them in order, as the JAX scan carries them. Then one clip, one
optimizer step and one EMA; loss and accuracy are the micro-batches' mean.

The random sources are explicit: ``DropoutRng`` (host generator: attention
seeds and layerdrop; device generator: dither, dropout, negatives).
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
    check_collapse,
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


def mixed_precision_params(named_parameters) -> dict:
    """``{name: parameter.to(torch.bfloat16)}`` of (name, parameter) pairs,
    for ``torch.func.functional_call``: the cast is differentiable, so a
    backward through the copies leaves float32 gradients on the float32
    masters (the JAX step's ``_cast``)."""
    return {n: p.to(torch.bfloat16) for n, p in named_parameters}


def micro_batches(batch, accum_steps: int) -> list:
    """The step's micro-batches: ``[batch]``, or the list of ``accum_steps``
    of them."""
    micro = list(batch) if accum_steps > 1 else [batch]
    if len(micro) != accum_steps:
        raise ValueError(f"accum_steps={accum_steps} needs that many micro-batches, "
                         f"got {len(micro)}")
    return micro


def _pretrain_loss(model: ST2VecEncoder, batch: dict, rng: DropoutRng, bf16: bool,
                   neg_idx: Optional[torch.Tensor]):
    """One micro-batch's forward: (loss, accuracy, teacher layers, student
    layers)."""
    cfg = model.cfg
    emb = torch.tensor(gaussian_mask_emb(cfg.num_features), device=batch["wavs"].device)
    t_specs, t_lens = wav_to_spec(cfg, batch["wavs"], batch["wav_lens"],
                                  training=True, generator=rng.device)
    s_specs, s_lens = wav_to_spec(cfg, batch["p_wavs"], batch["p_wav_lens"],
                                  training=True, generator=rng.device)
    if bf16:
        # the featurizer stays float32; each tower runs on bf16 copies of its
        # own parameters (the teacher's made without a graph)
        named = list(model.named_parameters())
        with torch.no_grad():
            params = {"teacher": mixed_precision_params(
                (n, p) for n, p in named if n.startswith("target_"))}
        params["student"] = mixed_precision_params(
            (n, p) for n, p in named if not n.startswith("target_"))
        emb, t_specs, s_specs = (x.to(torch.bfloat16) for x in (emb, t_specs, s_specs))

        def tower(*args, name):
            return torch.func.functional_call(model, params[name], args, {"tower": name})
    else:
        def tower(*args, name):
            return model(*args, tower=name)
    k, r = int(batch["shift_k"]), int(batch["shift_r"])
    with torch.no_grad():
        t_sh, t_lens_sh = teacher_shift(t_specs, t_lens, k, r, cfg.shift_unit,
                                        cfg.max_shift, emb)
        targets, _ = tower(t_sh, t_lens_sh, rng, name="teacher")
        # trim the k leading shifted frames -> aligned with the student frames
        targets = targets[:, k:k + s_specs.shape[1] // cfg.shift_unit]
    teacher_layers = model.target_feature_encoder.layers_run()

    s_specs = apply_mask(s_specs, batch["time_mask"], batch["chan_mask"], emb)
    pred, feat_lens = tower(s_specs, s_lens, rng, name="student")
    student_layers = model.feature_encoder.layers_run()

    t_out = pred.shape[1]
    valid = (torch.arange(t_out, device=pred.device)[None, :]
             < feat_lens[:, None]).to(pred.dtype)
    if neg_idx is None:
        neg_idx = draw_negative_indices(feat_lens, t_out, cfg.n_negatives, rng.device)
    negs = gather_negatives(targets, neg_idx)
    loss, acc = contrastive_loss(pred, targets, negs, valid, cfg.logit_temp)
    return loss, acc, teacher_layers, student_layers


def pretrain_step(state: SpiralPretrainState, batch, rng: DropoutRng,
                  grad_clip: Optional[float] = None, bf16: bool = False,
                  accum_steps: int = 1, neg_idx=None) -> dict:
    """One update of ``state`` in place from a device batch (the dict of
    ``host_augment_batch`` as tensors on the model's device; ``shift_k`` and
    ``shift_r`` stay host ints), or from a list of ``accum_steps`` such
    micro-batches. ``neg_idx`` (B, T', N), a list of one per micro-batch when
    accumulating, replaces the drawn negative indices (the parity tests pass
    JAX's). ``bf16`` runs the network in bf16 on copies of the float32
    parameters. Returns the step's metrics: ``loss`` and ``accuracy`` (0-d
    device tensors, the micro-batches' mean), ``momentum`` and ``lr``
    (floats), and the transformer layers each tower ran (summed over the
    micro-batches)."""
    micro = micro_batches(batch, accum_steps)
    negs = list(neg_idx) if accum_steps > 1 and neg_idx is not None else [neg_idx] * accum_steps
    model = state.model
    cfg = model.cfg
    params = model.student_parameters()
    for p in params:
        p.grad = None
    loss_sum = acc_sum = 0.0
    teacher_layers = student_layers = 0
    for mb, neg in zip(micro, negs):
        loss, acc, t_layers, s_layers = _pretrain_loss(model, mb, rng, bf16, neg)
        (loss / accum_steps).backward()
        loss_sum, acc_sum = loss_sum + loss.detach(), acc_sum + acc.detach()
        teacher_layers, student_layers = teacher_layers + t_layers, student_layers + s_layers
    for p in params:
        if p.grad is None:  # not reached by this forward (layerdrop)
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in params], grad_clip)
    lr = state.optimizer.step()
    m = momentum_schedule(state.step, cfg.target_momentum,
                          cfg.target_momentum_final, cfg.target_momentum_steps)
    ema_update(model, m)
    state.step += 1
    return {"loss": loss_sum / accum_steps, "accuracy": acc_sum / accum_steps,
            "momentum": m, "lr": lr, "teacher_layers": teacher_layers,
            "student_layers": student_layers}


@torch.no_grad()
def validation_loss(model: ST2VecEncoder, batch: dict, neg_idx=None,
                    generator: Optional[torch.Generator] = None):
    """The no-update contrastive loss of one device batch with train=False
    (the JAX runner's ``validate:365-423``): no dither, dropout or layerdrop,
    BatchNorm on its running statistics; the EMA teacher on the shifted clean
    specs, the student on the masked perturbed specs, InfoNCE, and
    ``check_collapse`` on the same tensors. The negatives' indices are
    ``neg_idx`` (B, T', N), or are drawn from ``generator``. Returns (loss,
    accuracy, diagnostics) as 0-d tensors; the model's mode is restored."""
    cfg = model.cfg
    was_training = model.training
    model.eval()
    try:
        emb = torch.tensor(gaussian_mask_emb(cfg.num_features), device=batch["wavs"].device)
        t_specs, t_lens = wav_to_spec(cfg, batch["wavs"], batch["wav_lens"])
        s_specs, s_lens = wav_to_spec(cfg, batch["p_wavs"], batch["p_wav_lens"])
        k, r = int(batch["shift_k"]), int(batch["shift_r"])
        t_sh, t_lens_sh = teacher_shift(t_specs, t_lens, k, r, cfg.shift_unit, cfg.max_shift,
                                        emb)
        targets, _ = model(t_sh, t_lens_sh, tower="teacher")
        targets = targets[:, k:k + s_specs.shape[1] // cfg.shift_unit]
        s_specs = apply_mask(s_specs, batch["time_mask"], batch["chan_mask"], emb)
        pred, feat_lens = model(s_specs, s_lens, tower="student")
        t_out = pred.shape[1]
        valid = (torch.arange(t_out, device=pred.device)[None, :]
                 < feat_lens[:, None]).to(pred.dtype)
        if neg_idx is None:
            neg_idx = draw_negative_indices(feat_lens, t_out, cfg.n_negatives, generator)
        loss, acc = contrastive_loss(pred, targets, gather_negatives(targets, neg_idx), valid,
                                     cfg.logit_temp)
        return loss, acc, check_collapse(pred, targets, feat_lens)
    finally:
        model.train(was_training)


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
