"""SPIRAL CTC finetuning: the training step.

Port of ``tpu_speech/models/spiral/ctc.py::make_finetune_step:158``, with its
bf16 mixed precision and gradient accumulation (``CTCTrainState:150``
becomes ``FinetuneState``). One step, as the JAX one: wav -> spec with
train-mode dither; the batch's time and channel masks (when it has them,
``:193-196``); the model in train mode, its encoder frozen or not;
``ctc_loss``; gradients, with zeros for every parameter the backward did not
reach (a layer layerdrop skipped, the whole encoder while it is frozen: JAX
differentiates every leaf and optax moves every leaf, so a frozen encoder
still decays by lr * weight_decay); the optimizer. There is no clip: the JAX
step has none.

``bf16`` and ``accum_steps`` work as in ``train/spiral.py::pretrain_step``:
float32 masters and bf16 copies through ``torch.func.functional_call``, the
featurizer and the CTC loss in float32; a list of micro-batches, each with
its own forward and backward, one optimizer step per call. The mask
embedding takes the specs' dtype. (The JAX step fills bf16 specs with its
float32 embedding, which promotes the whole network to float32 whenever the
batch has time masks; ROADMAP Queue 3.)

The freeze gate is the caller's host-side decision (``step_auto:252-267``
reads the runner's iteration counter), decided once per call, so the step
never reads the device.

Over N data-parallel ranks each runs its slice of the global batch: the CTC
mean divides each rank's sum by the global batch size, the replicated
gradients are summed after the last micro-batch's backward, and the logged
loss is the global one, as in ``train/spiral.py::pretrain_step``.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel, ctc_loss
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.masking import apply_mask, gaussian_mask_emb
from tpu_speech_torch.models.spiral.st2vec import wav_to_spec
from tpu_speech_torch.parallel.mesh import allreduce_grads, global_count, global_metrics
from tpu_speech_torch.train.spiral import micro_batches, mixed_precision_params


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


def _finetune_loss(model: CTCFinetuneModel, batch: dict, rng: DropoutRng,
                   freeze_encoder: bool, bf16: bool):
    cfg = model.encoder.cfg
    specs, spec_lens = wav_to_spec(cfg, batch["wavs"], batch["wav_lens"],
                                   training=True, generator=rng.device)
    if bf16:
        specs = specs.to(torch.bfloat16)
    if "time_mask" in batch:
        emb = torch.tensor(gaussian_mask_emb(cfg.num_features), device=specs.device,
                           dtype=specs.dtype)
        specs = apply_mask(specs, batch["time_mask"], batch.get("chan_mask"), emb)
    if bf16:
        log_probs, logit_lens = torch.func.functional_call(
            model, mixed_precision_params(model.named_parameters()), (specs, spec_lens, rng),
            {"freeze_encoder": freeze_encoder})
    else:
        log_probs, logit_lens = model(specs, spec_lens, rng, freeze_encoder=freeze_encoder)
    count = global_count(log_probs.new_full((), len(log_probs), dtype=torch.float32))
    return ctc_loss(log_probs, logit_lens, batch["labels"], batch["label_lens"],
                    model.blank_idx, count)


def finetune_step(state: FinetuneState, batch, rng: DropoutRng,
                  freeze_encoder: bool = False, bf16: bool = False,
                  accum_steps: int = 1) -> dict:
    """One update of ``state`` in place from a device batch (``wavs``,
    ``wav_lens``, ``labels``, ``label_lens`` and optionally ``time_mask`` /
    ``chan_mask``), or from a list of ``accum_steps`` of them. Returns
    ``loss`` (a 0-d device tensor, the micro-batches' mean), ``lr`` (a float)
    and the transformer layers the encoder ran (summed over the
    micro-batches)."""
    micro = micro_batches(batch, accum_steps)
    model = state.model
    model.train()
    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss_sum, layers = 0.0, 0
    for mb in micro:
        loss = _finetune_loss(model, mb, rng, freeze_encoder, bf16)
        (loss / accum_steps).backward()
        loss_sum = loss_sum + loss.detach()
        layers += model.encoder.feature_encoder.layers_run()
    for p in params:
        if p.grad is None:  # not reached: a skipped layer, a frozen encoder
            p.grad = torch.zeros_like(p)
    comm = allreduce_grads(params)
    (loss_sum,) = global_metrics(loss_sum)
    lr = state.optimizer.step()
    state.step += 1
    return {"loss": loss_sum / accum_steps, "lr": lr, "layers": layers,
            "allreduce_bytes": comm}
