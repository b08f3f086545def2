"""Grad-TTS training: the step and the epoch loop.

The port's counterpart of ``tpu_speech/train/gradtts.py`` (the reference loop
Grad-TTS/train.py:97-175). ``train_step`` is ``make_train_step:29``'s step:
the loss (encoder, log-prior, MAS on the hand CUDA kernel, duration loss, the
random ``out_size`` crop, diffusion and prior losses), backward, the encoder
and the estimator clipped separately to norm 1 (``spk_emb`` left unclipped,
as the JAX step leaves it), then Adam (``AdamW`` with ``weight_decay = 0``,
which is ``optax.adam`` step for step). It makes no host sync. Its draws (t,
z, the crop offsets) come from a ``torch.Generator`` on the batch's device,
seeded per step from (seed, iteration) by ``train/trainer.py::step_generator``:
the counterpart of ``fold_in(base_rng, iteration)`` (``:231``), so a resumed
run draws what a straight run would. Dropout stays on torch's default
generator, whose state the checkpoint keeps. ``bf16=True`` is the JAX step's
mixed precision (``make_train_step(..., bf16)``, ``:30-46``): bf16 copies of
the float32 parameters and of ``y`` run the forward through
``torch.func.functional_call``; the network follows the JAX package's dtype
promotion (MAS takes the bf16 log-prior times the mask in fp32, the draws
come in y's dtype, the time embedding's dense layers in fp32); the loss is
summed in bf16 and returned in float32; the gradients land on the float32
masters, which the clip and Adam update.

``GradTTSTrainer`` (``:86-274``) runs epochs on ``train/trainer.py::Trainer``:
the ``train.log`` line per epoch, TensorBoard scalars every 10 steps, a
checkpoint every ``save_every`` epochs, ``resume_if_exists``, synthesis
previews, and at the end ``save_state_dict``: a reference-named ``.pt`` (the
reference's own checkpoint format, Grad-TTS/train.py:174-175) that
``cli/inference.py`` loads.

Over N ranks (``train/trainer.py``) ``train_step`` runs on the rank's rows:
the model draws the crop offsets, t and z at the global batch's shape and
keeps its rows, MAS runs on the rank's own rows, the three losses divide by
the global counts (one all-reduce, ``models/grad_tts.py``), the gradients
are summed over the ranks before the two clips, and the metrics are the
global batch's (one more all-reduce).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_speech_torch.models.grad_tts import GradTTS, synthesize
from tpu_speech_torch.parallel.mesh import allreduce_grads, global_metrics
from tpu_speech_torch.train.optim import AdamW, clip_subtree_by_global_norm
from tpu_speech_torch.train.spiral import mixed_precision_params
from tpu_speech_torch.train.trainer import Trainer, batch_to_device, step_generator

ENCODER = ("encoder.",)
ESTIMATOR = ("decoder.estimator.",)
MAX_GRAD_NORM = 1.0  # per module (Grad-TTS/train.py:115-118)
PREVIEW_TIMESTEPS = 50  # reverse-diffusion steps of the synthesis previews
PREVIEW_MAX_FRAMES = 512  # their mel length


def train_step(model: GradTTS, opt: AdamW, batch: dict,
               generator: Optional[torch.Generator] = None, out_size: Optional[int] = None,
               offsets=None, t=None, z=None, attn=None, bf16: bool = False) -> dict:
    """One update of ``model`` in place from a device batch (``x``,
    ``x_lengths``, ``y`` (B, Ty, F), ``y_lengths``, optional ``spk``).
    ``offsets``, ``t``, ``z`` and ``attn`` replace the draws and the MAS
    path (``GradTTS.forward``; under bf16, t and z in bf16). Returns the JAX
    package's metrics as 0-d device tensors: loss (float32), dur_loss,
    prior_loss, diff_loss (bf16 under bf16) and the pre-clip enc_grad_norm
    and dec_grad_norm."""
    params = list(model.named_parameters())
    for _, p in params:
        p.grad = None
    y, forward = batch["y"], model
    if bf16:
        copies = mixed_precision_params((n, p) for n, p in params if p.is_floating_point())
        y = y.to(torch.bfloat16)

        def forward(*args, **kwargs):
            return torch.func.functional_call(model, copies, args, kwargs)
    dur, prior, diff = forward(batch["x"], batch["x_lengths"], y, batch["y_lengths"],
                               spk=batch.get("spk"), out_size=out_size, generator=generator,
                               offsets=offsets, t=t, z=z, attn=attn)
    (dur + prior + diff).float().backward()
    for _, p in params:
        if p.grad is None:  # a leaf the loss does not reach: JAX's gradient is zero
            p.grad = torch.zeros_like(p)
    allreduce_grads(p for _, p in params)
    dur, prior, diff = global_metrics(dur, prior, diff)
    loss = (dur + prior + diff).float()
    enc_norm = clip_subtree_by_global_norm(params, ENCODER, MAX_GRAD_NORM)
    dec_norm = clip_subtree_by_global_norm(params, ESTIMATOR, MAX_GRAD_NORM)
    opt.step()
    return {"loss": loss.detach(), "dur_loss": dur.detach(), "prior_loss": prior.detach(),
            "diff_loss": diff.detach(), "enc_grad_norm": enc_norm, "dec_grad_norm": dec_norm}


class GradTTSTrainer(Trainer):
    """The epoch loop: train.log, TensorBoard, checkpoints, resume, previews
    (mel and alignment images, Grad-TTS/train.py:142-175)."""

    def __init__(self, model: GradTTS, log_dir: str, learning_rate: float = 1e-4,
                 out_size: Optional[int] = None, save_every: int = 1, seed: int = 0, exp=None,
                 preview_batch=None, bf16: bool = False):
        """preview_batch: a dict of padded int32 ``x`` (B, Tx) and
        ``x_lengths`` (and ``spk``) for the per-epoch synthesis previews the
        reference logs as its de facto integration test. bf16: the
        mixed-precision step (``train_step``)."""
        super().__init__(model, log_dir, learning_rate, save_every, seed, exp)
        self.out_size = out_size
        self.preview_batch = preview_batch
        self.bf16 = bf16

    def log_ground_truth(self, batch, n: int = 3):
        """Log target mels once at startup (Grad-TTS/train.py:89-95)."""
        if self.tb is None:
            return
        from tpu_speech_torch.utils.plotting import plot_tensor

        for i in range(min(n, len(batch["y"]))):
            length = int(batch["y_lengths"][i])
            img = plot_tensor(np.asarray(batch["y"][i][:length]).T)
            self.tb.add_image(f"image_{i}/ground_truth", img, 0, dataformats="HWC")

    def log_previews(self, epoch: int, n: int = 3):
        """Per-epoch synthesis previews through ``synthesize``: the encoder's
        and decoder's mels and the alignment, to TensorBoard and as PNGs in
        the log dir (Grad-TTS/train.py:142-172)."""
        if self.preview_batch is None:
            return
        from tpu_speech_torch.utils.plotting import plot_tensor, save_plot

        pb = batch_to_device(self.preview_batch, self.device)
        self.model.eval()
        try:
            with torch.no_grad():
                enc, dec, attn, ylen = synthesize(
                    self.model, pb["x"], pb["x_lengths"], PREVIEW_TIMESTEPS,
                    PREVIEW_MAX_FRAMES, spk=pb.get("spk"),
                    generator=torch.Generator(self.device).manual_seed(epoch))
        finally:
            self.model.train()
        enc, dec, attn = enc.cpu().numpy(), dec.cpu().numpy(), attn.cpu().numpy()
        ylen = ylen.cpu().numpy()
        for i in range(min(n, len(enc))):
            frames = max(int(ylen[i]), 1)
            tx_len = int(self.preview_batch["x_lengths"][i])
            images = {"generated_enc": enc[i][:frames].T, "generated_dec": dec[i][:frames].T,
                      "alignment": attn[i][:tx_len, :frames]}
            for tag, img in images.items():
                if self.tb is not None:
                    self.tb.add_image(f"image_{i}/{tag}", plot_tensor(img), self.iteration,
                                      dataformats="HWC")
                save_plot(img, os.path.join(self.log_dir, f"{tag}_{i}.png"))

    def train_epoch(self, loader, epoch: int) -> dict:
        self.model.train()
        agg = {"dur_loss": [], "prior_loss": [], "diff_loss": []}
        t0 = time.time()
        n_frames = 0
        for batch in loader:
            generator = step_generator(self.seed, self.iteration, self.device)
            n_frames += int(np.sum(batch["y_lengths"]))  # from the host batch: no sync
            batch = batch_to_device(self.shard(batch), self.device)
            self.timer.tick("step")
            metrics = train_step(self.model, self.opt, batch, generator, self.out_size,
                                 bf16=self.bf16)
            # one read of every metric: the sync that closes the step
            m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            self.timer.tock("step")
            if self.tb is not None and self.iteration % 10 == 0:
                for tag, key in (("duration_loss", "dur_loss"), ("prior_loss", "prior_loss"),
                                 ("diffusion_loss", "diff_loss"),
                                 ("encoder_grad_norm", "enc_grad_norm"),
                                 ("decoder_grad_norm", "dec_grad_norm")):
                    self.tb.add_scalar(f"training/{tag}", m[key], self.iteration)
                st = self.timer.summary().get("step")
                if st is not None:
                    self.tb.add_scalar("training/step_time_ms", st["mean_s"] * 1e3,
                                       self.iteration)
            for k in agg:
                agg[k].append(m[k])
            self.iteration += 1

        dt = time.time() - t0
        means = {k: float(np.mean(v)) if v else float("nan") for k, v in agg.items()}
        msg = ("Epoch %d: duration loss = %.3f | prior loss = %.3f | diffusion loss = %.3f "
               "| %.0f frames/s\n" % (epoch, means["dur_loss"], means["prior_loss"],
                                      means["diff_loss"], n_frames / max(dt, 1e-9)))
        if self.primary:
            with open(os.path.join(self.log_dir, "train.log"), "a") as f:
                f.write(msg)
        if epoch % self.save_every == 0:
            self.save_checkpoint()
            if self.primary:
                self.log_previews(epoch)
        return means
