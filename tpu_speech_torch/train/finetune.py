"""SPIRAL CTC finetuning: the training step.

Port of ``tpu_speech/models/spiral/ctc.py::make_finetune_step:158`` at
``accum_steps=1`` and fp32 (``CTCTrainState:150`` becomes ``FinetuneState``).
One step, as the JAX one: wav -> spec with train-mode dither; the batch's
time and channel masks (when it has them, ``:193-196``); the model in train
mode, its encoder frozen or not; ``ctc_loss``; gradients, with zeros for every
parameter the backward did not reach (a layer layerdrop skipped, the whole
encoder while it is frozen: JAX differentiates every leaf and optax moves
every leaf, so a frozen encoder still decays by lr * weight_decay); the
optimizer. There is no clip: the JAX step has none.

The freeze gate is the caller's host-side decision (``step_auto:252-267``
reads the runner's iteration counter), so the step never reads the device.

Not ported yet: ``bf16=True`` and ``accum_steps > 1``; both raise.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel, ctc_loss
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.masking import apply_mask, gaussian_mask_emb
from tpu_speech_torch.models.spiral.st2vec import wav_to_spec


@dataclasses.dataclass
class FinetuneState:
    """The CTC model, the optimizer over all of its parameters, and the step
    count."""

    model: CTCFinetuneModel
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_finetune_state(model: CTCFinetuneModel, make_opt) -> FinetuneState:
    """``make_opt(params) -> optimizer`` receives every model parameter."""
    model.train()
    return FinetuneState(model, make_opt(list(model.parameters())))


def finetune_step(state: FinetuneState, batch: dict, rng: DropoutRng,
                  freeze_encoder: bool = False, bf16: bool = False,
                  accum_steps: int = 1) -> dict:
    """One update of ``state`` in place from a device batch: ``wavs``,
    ``wav_lens``, ``labels``, ``label_lens`` and optionally ``time_mask`` /
    ``chan_mask``. Returns ``loss`` (a 0-d device tensor), ``lr`` (a float)
    and the transformer layers the encoder ran."""
    if bf16:
        raise NotImplementedError("bf16 finetuning is not ported yet")
    if accum_steps != 1:
        raise NotImplementedError("accum_steps > 1 is not ported yet")
    model = state.model
    model.train()
    cfg = model.encoder.cfg
    specs, spec_lens = wav_to_spec(cfg, batch["wavs"], batch["wav_lens"],
                                   training=True, generator=rng.device)
    if "time_mask" in batch:
        emb = torch.tensor(gaussian_mask_emb(cfg.num_features), device=specs.device)
        specs = apply_mask(specs, batch["time_mask"], batch.get("chan_mask"), emb)
    log_probs, logit_lens = model(specs, spec_lens, rng, freeze_encoder=freeze_encoder)
    loss = ctc_loss(log_probs, logit_lens, batch["labels"], batch["label_lens"],
                    model.blank_idx)

    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss.backward()
    for p in params:
        if p.grad is None:  # not reached: a skipped layer, a frozen encoder
            p.grad = torch.zeros_like(p)
    lr = state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach(), "lr": lr,
            "layers": model.encoder.feature_encoder.layers_run()}
