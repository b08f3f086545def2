"""GE2E speaker-encoder training.

The port's counterpart of ``tpu_speech/train/speaker_encoder.py`` (the
reference DiffVC/speaker_encoder/encoder/train.py), fp32 on one device:

- ``ge2e_train_step`` (``make_ge2e_train_step:40``): speakers x utterances
  partials -> embeddings -> the GE2E loss; the similarity pair's gradients
  scaled by 0.01, then every gradient, the pair's included, clipped to one
  global norm of 3, then Adam. The encoder stays in train mode (it has no
  dropout; cuDNN's LSTM runs its backward only in training mode). The step
  makes no host sync: its metrics are device tensors.
- ``train_speaker_encoder`` (``:79``): the loop. The loss and EER report
  every ``vis_every`` steps averages a window of device tensors read at
  report time, not once a step; 2-D PCA projections of the last batch's
  embeddings every ``umap_every`` steps (matplotlib); a checkpoint every
  ``save_every`` steps in ``<models_dir>/<run_id>/ckpt`` (the model, Adam,
  the step and the sampler's state, so a resumed run draws the batches a
  straight run would), a backup every ``backup_every`` steps, and
  ``<models_dir>/<run_id>.pt`` holding ``{'model_state', 'step'}``, the
  reference's format, which ``cli.inference_vc --spk-encoder`` loads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_speech_torch.data.speaker_verification import SpeakerVerificationSampler
from tpu_speech_torch.models.speaker_encoder import SpeakerEncoder, equal_error_rate, ge2e_loss
from tpu_speech_torch.train.optim import AdamW, clip_by_global_norm
from tpu_speech_torch.train.trainer import Trainer
from tpu_speech_torch.utils.checkpoint import Checkpointer

SIM_GRAD_SCALE = 0.01  # encoder/model.py:44-48 (do_gradient_ops)
MAX_GRAD_NORM = 3.0


def ge2e_train_step(model: SpeakerEncoder, opt: AdamW, frames: torch.Tensor) -> dict:
    """One update from device frames (S, U, T, n_mels). Returns the loss,
    the pre-clip global norm, the (S U, S) similarity and the (S, U, E)
    embeddings, all device tensors."""
    s, u, t, f = frames.shape
    params = list(model.parameters())
    for p in params:
        p.grad = None
    embeds = model(frames.reshape(s * u, t, f)).reshape(s, u, -1)
    loss, sim = ge2e_loss(embeds, model.similarity_weight, model.similarity_bias)
    loss.backward()
    torch._foreach_mul_([model.similarity_weight.grad, model.similarity_bias.grad],
                        SIM_GRAD_SCALE)
    norm = clip_by_global_norm([p.grad for p in params], MAX_GRAD_NORM)
    opt.step()
    return {"loss": loss.detach(), "grad_norm": norm, "sim": sim.detach(),
            "embeds": embeds.detach()}


def save_model_state(path: str, model: SpeakerEncoder, step: int) -> None:
    """``{'model_state': state_dict, 'step': step}`` (the reference's file)."""
    torch.save({"model_state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "step": step}, path)


def train_speaker_encoder(
    clean_data_root: str,
    models_dir: str,
    run_id: str = "ge2e",
    speakers_per_batch: int = 64,
    utterances_per_speaker: int = 10,
    n_frames: int = 160,
    learning_rate: float = 1e-4,
    max_steps: int = 1_000_000,
    vis_every: int = 10,
    umap_every: int = 100,
    save_every: int = 500,
    backup_every: int = 7500,
    force_restart: bool = False,
    seed: int = 0,
    device="cuda",
) -> dict:
    """The reference GE2E loop (encoder/train.py:18-126) on ``device``.
    Returns the model, the last step, the reports ``(step, mean loss, mean
    EER)``, the ``.pt`` path and the host timer's summary (``batch``: the
    sampler's host time a step, its ``.npy`` loads and crops)."""
    from tpu_speech_torch.utils.plotting import plot_projections

    sampler = SpeakerVerificationSampler(clean_data_root, speakers_per_batch,
                                         utterances_per_speaker, n_frames, seed=seed)
    model = SpeakerEncoder().init_weights(torch.Generator().manual_seed(seed)).to(device)
    os.makedirs(models_dir, exist_ok=True)
    trainer = Trainer(model, os.path.join(models_dir, run_id), learning_rate, seed=seed)
    backup_dir = os.path.join(models_dir, f"{run_id}_backups")
    model_path = os.path.join(models_dir, f"{run_id}.pt")
    if not force_restart:
        state = trainer.ckpt.restore_latest()
        if state is not None:
            trainer.load_state(state)
            sampler.load_state(state["sampler"])
            print(f"Resuming '{run_id}' at step {trainer.iteration}.")

    def state():
        return dict(trainer.state(), sampler=sampler.state())

    model.train()
    window, reports = [], []
    for step in range(trainer.iteration + 1, max_steps + 1):
        with trainer.timer.measure("batch"):
            frames = sampler.next_batch().reshape(speakers_per_batch, utterances_per_speaker,
                                                  n_frames, -1)
            frames = torch.from_numpy(frames).to(trainer.device, non_blocking=True)
        metrics = ge2e_train_step(model, trainer.opt, frames)
        trainer.iteration = step
        window.append((metrics["loss"], metrics["sim"]))
        if step % vis_every == 0:
            losses = torch.stack([lo for lo, _ in window]).tolist()
            sims = torch.stack([sim for _, sim in window]).cpu().numpy()
            eers = [equal_error_rate(sim, speakers_per_batch) for sim in sims]
            reports.append((step, float(np.mean(losses)), float(np.mean(eers))))
            print(f"Step {step:6d}   Loss: {reports[-1][1]:.4f}   EER: {reports[-1][2]:.4f}",
                  flush=True)
            window.clear()
        if umap_every and step % umap_every == 0:
            os.makedirs(backup_dir, exist_ok=True)
            embeds = metrics["embeds"].cpu().numpy()
            plot_projections(embeds.reshape(-1, embeds.shape[-1]), utterances_per_speaker, step,
                             os.path.join(backup_dir, f"{run_id}_proj_{step:06d}.png"))
        if save_every and step % save_every == 0:
            trainer.ckpt.save(step, state())
            save_model_state(model_path, model, step)
        if backup_every and step % backup_every == 0:
            bak = Checkpointer(os.path.join(backup_dir, f"bak_{step:06d}"))
            bak.save(step, state())
            bak.wait()
    trainer.ckpt.wait()  # drain the last checkpoint write
    save_model_state(model_path, model, trainer.iteration)
    return {"model": model, "step": trainer.iteration, "reports": reports,
            "model_path": model_path, "times": trainer.timer.summary()}
