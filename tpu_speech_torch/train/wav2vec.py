"""wav2vec 2.0 pretraining step: InfoNCE at the masked frames against the
quantized targets, plus the codebook-perplexity and feature penalties.

Port of ``tpu_speech/train/wav2vec.py``: ``host_time_mask:28`` (numpy, a
copy: the span mask over conv-output frames, drawn on the host as the
reference does), ``init_wav2vec_state:51`` (``make_wav2vec_state``: the
model in training mode and an optimizer over its parameters, such as
``torch.optim.AdamW``) and ``make_pretrain_step:62`` (``pretrain_step``).

One step, as the JAX one: the forward with the span mask; per-frame
negatives drawn from the same utterance's valid frames (``neg_idx`` replaces
the draw: the parity tests pass JAX's indices); InfoNCE
(``st2vec.contrastive_loss``) weighted by ``loss_weight`` (masked and valid
frames); ``+ prob_ppl_weight * prob_ppl_loss + feature_loss_weight *
features_penalty``; the gradients; the optional global-norm clip; the
optimizer. The Gumbel noise comes from ``gumbel`` or the rng's device
generator.

``bf16=True`` casts as JAX does (``:69-77``): the forward runs on bf16 copies
of the float32 parameters (``train/spiral.py::mixed_precision_params``,
through ``torch.func.functional_call``) and on bf16 waves; the optimizer
keeps the float32 masters, and the gradients reach them in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.masking import compute_mask_indices
from tpu_speech_torch.models.spiral.st2vec import (
    contrastive_loss,
    draw_negative_indices,
    gather_negatives,
)
from tpu_speech_torch.models.spiral.wav2vec_model import (
    Wav2Vec2Config,
    Wav2Vec2Model,
    conv_subsampled_lens,
)
from tpu_speech_torch.train.optim import clip_by_global_norm
from tpu_speech_torch.train.spiral import mixed_precision_params


def host_time_mask(cfg: Wav2Vec2Config, wav_lens: np.ndarray, max_frames: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(B, max_frames) bool span mask over conv-output frames (the
    reference's numpy mask indices, wav2vec_model.py:391-429), on the host."""
    feat_lens = conv_subsampled_lens(cfg, np.asarray(wav_lens))
    mask, _ = compute_mask_indices(
        (len(feat_lens), max_frames), feat_lens, cfg.mask_prob, cfg.mask_length,
        shrink_to_batch_min=False, rng=rng)
    return mask.astype(bool)


@dataclasses.dataclass
class Wav2VecState:
    """The model, the optimizer over its parameters, and the step count
    (the quantizer's temperature schedule reads it)."""

    model: Wav2Vec2Model
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_wav2vec_state(model: Wav2Vec2Model, make_opt) -> Wav2VecState:
    """``make_opt(params) -> optimizer`` receives every parameter."""
    model.train()
    return Wav2VecState(model, make_opt(list(model.parameters())))


def pretrain_step(state: Wav2VecState, wavs, wav_lens, time_mask, rng: DropoutRng,
                  grad_clip: Optional[float] = None, bf16: bool = False,
                  neg_idx: Optional[torch.Tensor] = None,
                  gumbel: Optional[torch.Tensor] = None) -> dict:
    """One update of ``state`` in place. wavs (B, S) float32, wav_lens (B,),
    time_mask (B, T) bool on the model's device. Returns the metrics (0-d
    tensors): ``loss``, ``contrastive_loss``, ``accuracy``, ``prob_ppl``,
    and ``cur_temp`` (a float) and ``layers`` (transformer layers run)."""
    model, cfg = state.model, state.model.cfg
    params = list(model.parameters())
    for p in params:
        p.grad = None
    args = (wavs.to(torch.bfloat16) if bf16 else wavs, wav_lens, time_mask)
    kw = {"num_updates": state.step, "rng": rng, "gumbel": gumbel}
    if bf16:
        out = torch.func.functional_call(
            model, mixed_precision_params(model.named_parameters()), args, kw)
    else:
        out = model(*args, **kw)
    targets = out["targets"]
    if neg_idx is None:
        neg_idx = draw_negative_indices(out["feat_lens"], targets.shape[1], cfg.n_negatives,
                                        rng.device)
    c_loss, acc = contrastive_loss(out["logits"], targets, gather_negatives(targets, neg_idx),
                                   out["loss_weight"], cfg.logit_temp)
    loss = (c_loss + cfg.prob_ppl_weight * out["prob_ppl_loss"]
            + cfg.feature_loss_weight * out["features_penalty"])
    loss.backward()
    for p in params:
        if p.grad is None:  # not reached by this forward (layerdrop)
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in params], grad_clip)
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach().float(), "contrastive_loss": c_loss.detach().float(),
            "accuracy": acc.detach(), "prob_ppl": out["prob_ppl"].detach(),
            "cur_temp": out["cur_temp"], "layers": model.layers_run()}
