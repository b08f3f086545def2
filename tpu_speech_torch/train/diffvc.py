"""DiffVC's two-stage training: the average-voice encoder, then the decoder.

The port's counterpart of ``tpu_speech/train/diffvc.py`` (the reference
DiffVC/train_enc.py:50-132 and train_dec.py:57-140), fp32 or bf16 on one
device:

- ``enc_train_step`` (``make_enc_train_step:35``): the masked MSE to the
  phoneme-averaged mels with dropout on, backward, every gradient clipped to
  one global norm of 1, then Adam;
- ``dec_train_step`` (``make_dec_train_step:73``): the score-matching loss
  with the encoder frozen (``DiffVC.forward``: its dropout off and no
  autograd), the encoder's gradients zeros, the estimator's alone clipped
  to norm 1, then Adam over every parameter as optax's runs: with zero
  gradients and zero moments the encoder moves by exactly 0.

Neither step syncs with the host: the metrics are 0-d device tensors that
``DiffVCTrainer`` reads once per step, as ``GradTTSTrainer`` does. The
decoder step's t and z come from the per-step generator
(``train/trainer.py::step_generator``, the counterpart of ``fold_in(base_rng,
iteration)``, ``:251``); dropout draws from torch's default generator, whose
state the checkpoint keeps. The previews (``make_enc_preview``,
``make_dec_preview``) write each item's Griffin-Lim wav to the log dir and,
with ``images``, its mel as a PNG and to TensorBoard.

``bf16=True`` is the JAX steps' mixed precision (``make_enc_train_step(...,
bf16)``, ``:27-52, 73-86``): the forward and backward run through
``torch.func.functional_call`` on bf16 copies of the float32 parameters
(``train/spiral.py::mixed_precision_params``), with the mels (and the speaker
embedding) in bf16; the loss comes back float32, the gradients land on the
float32 masters, and the clip and Adam run in float32.

Over N ranks (``train/trainer.py``) each step runs on the rank's rows of
the global batch: the losses divide by the global frame count, the
decoder's t and z are drawn at the global shape (``models/diffvc/
diffusion.py``), the gradients are summed over the ranks before the clip
(so ``grad_norm`` is the global one), and the loss is the global batch's.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpu_speech_torch.models.diffvc import DiffVC, FwdDiffusion, voice_convert
from tpu_speech_torch.models.diffvc.encoder import masked_mse
from tpu_speech_torch.ops.masks import sequence_mask
from tpu_speech_torch.parallel.mesh import allreduce_grads, global_counts, global_metrics
from tpu_speech_torch.train.optim import AdamW, clip_by_global_norm, clip_subtree_by_global_norm
from tpu_speech_torch.train.spiral import mixed_precision_params
from tpu_speech_torch.train.trainer import Trainer, batch_to_device, step_generator

ESTIMATOR = ("decoder.estimator.",)
MAX_GRAD_NORM = 1.0  # DiffVC/train_enc.py:89, train_dec.py:108
PREVIEW_TIMESTEPS = 30  # reverse-diffusion steps of the decoder's previews


def _zero_missing_grads(params) -> None:
    for p in params:
        if p.grad is None:  # a leaf the loss does not reach: JAX's gradient is zero
            p.grad = torch.zeros_like(p)


def _forward(model: torch.nn.Module, bf16: bool):
    """``model``'s forward, on bf16 copies of its floating parameters under
    ``bf16`` (differentiable casts: the gradients reach the masters)."""
    if not bf16:
        return model
    copies = mixed_precision_params(
        (n, p) for n, p in model.named_parameters() if p.is_floating_point())

    def forward(*args, **kwargs):
        return torch.func.functional_call(model, copies, args, kwargs)
    return forward


def enc_train_step(model: FwdDiffusion, opt: AdamW, batch: dict,
                   generator: Optional[torch.Generator] = None, bf16: bool = False) -> dict:
    """One update of the average-voice encoder from a device batch (``x``,
    ``y`` (B, T, F), ``lengths``). It draws nothing but dropout's masks;
    ``generator`` is the trainer's common argument. ``bf16``: the mixed
    precision of the module docstring. Returns the float32 loss and the
    pre-clip global norm as 0-d device tensors."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    x, y = batch["x"].transpose(1, 2), batch["y"].transpose(1, 2)
    if bf16:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    mask = sequence_mask(batch["lengths"], x.shape[2]).to(x.dtype)[:, None, :]
    counts = global_counts(torch.sum(batch["lengths"]))
    loss = masked_mse(_forward(model, bf16)(x, mask), y, mask, model.n_feats,
                      None if counts is None else counts[0]).float()
    loss.backward()
    _zero_missing_grads(params)
    allreduce_grads(params)
    loss, = global_metrics(loss)
    norm = clip_by_global_norm([p.grad for p in params], MAX_GRAD_NORM)
    opt.step()
    return {"loss": loss.detach(), "grad_norm": norm}


def dec_train_step(model: DiffVC, opt: AdamW, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                   bf16: bool = False) -> dict:
    """One update of the decoder from a device batch (``mel1``, ``mel2`` (B,
    T, F), ``mel_lengths``, ``c`` (B, 256)). ``t`` (B,) and ``z`` (B, T, F)
    replace the draws of ``generator`` (drawn in the mels' dtype: bf16 under
    ``bf16``, the module docstring's mixed precision). Returns the float32
    loss and the estimator's pre-clip norm as 0-d device tensors."""
    named = list(model.named_parameters())
    for _, p in named:
        p.grad = None
    mel1, mel2, c = batch["mel1"], batch["mel2"], batch["c"]
    if bf16:
        mel1, mel2, c = (v.to(torch.bfloat16) for v in (mel1, mel2, c))
    loss = _forward(model, bf16)(mel1, batch["mel_lengths"], mel2, c, t=t, z=z,
                                 generator=generator).float()
    loss.backward()
    _zero_missing_grads(p for _, p in named)  # the encoder's, all of them
    allreduce_grads(p for _, p in named)
    loss, = global_metrics(loss)
    norm = clip_subtree_by_global_norm(named, ESTIMATOR, MAX_GRAD_NORM)
    opt.step()
    return {"loss": loss.detach(), "grad_norm": norm}


def _log_mel_and_audio(trainer, tag: str, log_mel: np.ndarray, epoch: int, sample_rate: int,
                       n_mels: int, images: bool) -> None:
    """One preview item (``_log_mel_and_audio:113``; the reference's
    epoch-end logs, train_dec.py:115-136): the Griffin-Lim wav, peak
    normalised, as ``<log_dir>/<tag>.wav``; with ``images`` the mel as a PNG
    and a TensorBoard image."""
    from tpu_speech_torch.audio.vocode import fast_griffin_lim
    from tpu_speech_torch.data.wav import write_wav

    mel = np.asarray(log_mel, np.float32)
    stem = tag.replace("/", "_")
    with torch.no_grad():
        wav = fast_griffin_lim(torch.from_numpy(mel)[None].to(trainer.device), n_mels=n_mels,
                               sample_rate=sample_rate)[0].cpu().numpy()
    wav = wav / (np.abs(wav).max() + 1e-6)
    write_wav(os.path.join(trainer.log_dir, f"{stem}.wav"), wav, sample_rate)
    if trainer.tb is not None:
        try:
            trainer.tb.add_audio(f"{tag}/audio", wav[:, None], epoch, sample_rate=sample_rate)
        except (ImportError, RuntimeError, ValueError):
            pass  # TensorBoard's audio encoder is missing; the wav is on disk
    if images:
        from tpu_speech_torch.utils.plotting import plot_tensor, save_plot

        if trainer.tb is not None:
            trainer.tb.add_image(f"{tag}/mel", plot_tensor(mel.T), epoch, dataformats="HWC")
        save_plot(mel.T, os.path.join(trainer.log_dir, f"{stem}.png"))


def make_enc_preview(batch: dict, n: int = 2, sample_rate: int = 22050,
                     images: bool = True) -> Callable:
    """Stage 1's preview (``make_enc_preview:145``; DiffVC/train_enc.py:
    111-132): for the first ``n`` items of a host batch, the source, the
    predicted average voice (eval mode) and the target average voice."""

    def preview(trainer, epoch):
        model = trainer.model
        m = min(n, len(batch["x"]))
        x = torch.from_numpy(np.asarray(batch["x"][:m])).to(trainer.device).transpose(1, 2)
        lens = np.asarray(batch["lengths"][:m])
        mask = sequence_mask(torch.from_numpy(lens).to(trainer.device), x.shape[2])
        model.eval()
        try:
            with torch.no_grad():
                pred = model(x, mask.to(x.dtype)[:, None, :]).transpose(1, 2).cpu().numpy()
        finally:
            model.train()
        for i in range(m):
            length = int(lens[i])
            for tag, mel in (("source", batch["x"][i]), ("predicted_avg", pred[i]),
                             ("target_avg", batch["y"][i])):
                _log_mel_and_audio(trainer, f"enc_{i}/{tag}", mel[:length], epoch, sample_rate,
                                   model.n_feats, images)

    return preview


def make_dec_preview(batch: dict, n: int = 2, sample_rate: int = 22050,
                     images: bool = True) -> Callable:
    """Stage 2's preview (``make_dec_preview:171``; DiffVC/train_dec.py:
    115-136): each of the first ``n`` items of a host batch converted to its
    own voice (``voice_convert``, ``PREVIEW_TIMESTEPS`` ml steps, draws
    seeded by the epoch), the source and the result."""

    def preview(trainer, epoch):
        model = trainer.model
        m = min(n, len(batch["mel1"]))
        dev = batch_to_device({k: np.asarray(batch[k][:m]) for k in ("mel1", "mel_lengths", "c")},
                              trainer.device)
        model.eval()
        try:
            with torch.no_grad():
                _, converted = voice_convert(
                    model, dev["mel1"], dev["mel_lengths"], dev["mel1"], dev["mel_lengths"],
                    dev["c"], PREVIEW_TIMESTEPS,
                    generator=torch.Generator(trainer.device).manual_seed(epoch))
        finally:
            model.train()
        converted = converted.cpu().numpy()
        for i in range(m):
            length = int(batch["mel_lengths"][i])
            _log_mel_and_audio(trainer, f"dec_{i}/source", batch["mel1"][i][:length], epoch,
                               sample_rate, model.n_feats, images)
            _log_mel_and_audio(trainer, f"dec_{i}/generated", converted[i][:length], epoch,
                               sample_rate, model.n_feats, images)

    return preview


class DiffVCTrainer(Trainer):
    """The epoch loop both stages share (``DiffVCTrainer:203``): one step
    function, ``train.log``, TensorBoard scalars every 10 steps, a
    checkpoint and the preview every ``save_every`` epochs, resume at the
    epoch after the checkpoint (``fit``), and the final reference-named
    ``state_dict``."""

    def __init__(self, model: torch.nn.Module, step_fn: Callable, log_dir: str,
                 learning_rate: float, save_every: int = 1, seed: int = 0, exp=None,
                 preview_fn: Optional[Callable] = None, bf16: bool = False):
        """step_fn: ``enc_train_step`` or ``dec_train_step``. preview_fn:
        called as ``preview_fn(trainer, epoch)`` after each checkpoint.
        bf16: the steps' mixed precision."""
        super().__init__(model, log_dir, learning_rate, save_every, seed, exp)
        self.step_fn = step_fn
        self.bf16 = bf16
        self.preview_fn = preview_fn
        self.history = []  # every step's metrics, read from the device once a step

    def train_epoch(self, loader, epoch: int) -> float:
        self.model.train()
        losses = []
        t0 = time.time()
        for batch in loader:
            generator = step_generator(self.seed, self.iteration, self.device)
            batch = batch_to_device(self.shard(batch), self.device)
            self.timer.tick("step")
            metrics = self.step_fn(self.model, self.opt, batch, generator, bf16=self.bf16)
            # one read of every metric: the sync that closes the step
            m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            self.timer.tock("step")
            self.history.append(m)
            losses.append(m["loss"])
            if self.tb is not None and self.iteration % 10 == 0:
                self.tb.add_scalar("training/loss", m["loss"], self.iteration)
                self.tb.add_scalar("training/grad_norm", m["grad_norm"], self.iteration)
            self.iteration += 1
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        if self.primary:
            with open(os.path.join(self.log_dir, "train.log"), "a") as f:
                f.write("Epoch %d: loss = %.4f | %.1fs\n" % (epoch, mean_loss, time.time() - t0))
        if epoch % self.save_every == 0:
            self.save_checkpoint()
            if self.preview_fn is not None and self.primary:
                self.preview_fn(self, epoch)
        return mean_loss

    def fit(self, loader, epochs: int) -> dict:
        """Resume from the log dir's latest checkpoint, at the epoch after
        it, and train up to epoch ``epochs``; the loader shuffles each epoch
        as a straight run would."""
        first_epoch = 1
        if self.resume_if_exists():
            first_epoch = self.iteration // max(len(loader), 1) + 1
            if self.primary:
                print(f"Resumed from iteration {self.iteration}")
        loader.set_epoch(first_epoch - 1)
        losses = []
        for epoch in range(first_epoch, epochs + 1):
            losses.append(self.train_epoch(loader, epoch))
            if self.primary:
                print(f"Epoch {epoch}: loss = {losses[-1]:.4f}")
        self.ckpt.wait()  # drain the last checkpoint write
        return {"first_epoch": first_epoch, "losses": losses, "iteration": self.iteration,
                "history": self.history, "log_dir": self.log_dir}
