"""HiFi-GAN adversarial training: the GAN step and the epoch driver.

The port's counterpart of ``tpu_speech/train/hifigan.py`` (the upstream V1
recipe). ``gan_train_step`` is ``make_gan_train_step:78``'s step, in the
upstream order:

1. the generator's forward on the input mel, without a graph;
2. the MPD + MSD LS-GAN loss on the real and generated wavs, then the
   discriminators' AdamW update;
3. the generator's loss against the updated discriminators: adversarial,
   plus 2x feature matching, plus 45 x L1 between the full-band mels
   (``fmax = sr / 2``) of the generated and the target wav; the
   discriminators run on detached weights there, so that the loss's
   gradient reaches only the generator (JAX differentiates ``state.gen``
   alone), and their real-wav feature maps are computed without a graph;
4. the generator's AdamW update.

The input mel is computed on the device (``audio/mel.py::mel_spectrogram``)
unless the batch carries ``"mel"`` (fine-tuning). The step makes no host
sync and returns the JAX package's seven metrics as 0-d device tensors.
``bf16=True`` runs both networks on bf16 copies of their float32 parameters
(``torch.func.functional_call``, as ``train/spiral.py``'s mixed precision)
and on bf16 copies of the wav and the input mel; both loss mels stay fp32;
the losses are summed and returned in float32 where the JAX step casts
them; the masters and AdamW's moments stay float32.

``make_optimizers`` is ``:64``'s pair of ``optax.adamw`` (b1 0.8, b2 0.99,
weight decay 0.01 on every leaf) on ``train/optim.py::AdamW``, with the
per-epoch staircase decay ``lr0 * 0.999 ** (count // steps_per_epoch)``.
``HiFiGANTrainer`` (``:178``) runs epochs: the ``train.log`` line and
TensorBoard scalars every 10 steps, ``validate`` (the full-band mel L1 over
at most 8 batches, up to ``log_audio`` wavs to TensorBoard), checkpoints and
``resume_if_exists``. A checkpoint holds both models, both optimizers'
moments and counts, the step, the epoch and the datasets' crop generators,
and is written by ``end_epoch`` after the epoch's validation, so that a
resumed run, which starts at the epoch after it, equals a straight one.

Over N ranks (one process a card, ``parallel/launch.py``) each rank runs the
step on its rows of the global batch: every loss is a mean over the global
batch (with equal shares, the local mean over N, summed), the
discriminators' gradients are summed over the ranks before their AdamW, then
the generator's before its own, and the metrics are the global ones. The
staircase decay counts global steps (every rank takes each one). Every rank
validates the whole validation set, as each JAX process does, and rank 0
alone writes files.
"""

from __future__ import annotations

import importlib.util
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpu_speech_torch.audio.mel import mel_spectrogram
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models.hifigan import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from tpu_speech_torch.parallel import distributed
from tpu_speech_torch.parallel.mesh import allreduce_grads, global_metrics, replicate, shard_batch
from tpu_speech_torch.train.optim import AdamW
from tpu_speech_torch.train.spiral import mixed_precision_params
from tpu_speech_torch.train.trainer import (
    batch_to_device,
    load_optimizer_state,
    optimizer_state,
)
from tpu_speech_torch.utils.checkpoint import Checkpointer
from tpu_speech_torch.utils.profiling import StepTimer

MEL_CFG = dict(n_fft=1024, num_mels=80, sampling_rate=22050, hop_size=256, win_size=1024,
               fmin=0.0, fmax=8000.0)
MEL_LOSS_WEIGHT = 45.0


def staircase_decay(learning_rate: float, lr_decay: float, steps_per_epoch: int):
    """``optax.exponential_decay(lr, steps_per_epoch, lr_decay,
    staircase=True)`` in float32: the schedule of AdamW's count, which is 0
    on the first update."""
    lr0, rate, steps = np.float32(learning_rate), np.float32(lr_decay), max(steps_per_epoch, 1)

    def schedule(count: int) -> float:
        return float(lr0 * rate ** np.float32(count // steps))

    return schedule


def make_optimizers(gen: nn.Module, disc: nn.Module, learning_rate: float = 2e-4,
                    adam_b1: float = 0.8, adam_b2: float = 0.99, lr_decay: float = 0.999,
                    steps_per_epoch: int = 1):
    """The generator's and the discriminators' AdamW (weight decay 0.01 on
    every parameter: optax's ``adamw`` has no mask), each on the staircase
    decay."""
    return tuple(AdamW(m.parameters(), staircase_decay(learning_rate, lr_decay, steps_per_epoch),
                       betas=(adam_b1, adam_b2), weight_decay=0.01) for m in (gen, disc))


def _runner(module: nn.Module, bf16: bool, trainable: bool):
    """``module``'s forward on its own parameters (fp32, trainable), on
    detached ones (fp32, frozen), or on bf16 copies of them (made with a
    graph when trainable): the gradient of a frozen run reaches no
    parameter."""
    named = list(module.named_parameters())
    if not bf16 and trainable:
        return module
    with torch.set_grad_enabled(trainable):
        params = (mixed_precision_params(named) if bf16
                  else {n: p.detach() for n, p in named})

    def run(*args):
        return torch.func.functional_call(module, params, args)

    return run


def gan_train_step(gen: Generator, mpd: MultiPeriodDiscriminator,
                   msd: MultiScaleDiscriminator, opt_g: AdamW, opt_d: AdamW, batch: dict,
                   mel_cfg: Optional[dict] = None, bf16: bool = False) -> dict:
    """One GAN update in place from a device batch: ``wav`` (B, S) float32
    and, fine-tuning, ``mel`` (B, S / hop, n_mels). ``opt_d`` holds the
    parameters of mpd and msd. Returns loss_gen, loss_disc, mel_error,
    loss_fm, loss_adv, loss_disc_mpd and loss_disc_msd."""
    cfg = dict(MEL_CFG, **(mel_cfg or {}))
    loss_cfg = dict(cfg, fmax=cfg["sampling_rate"] / 2.0)
    dtype = torch.bfloat16 if bf16 else torch.float32
    wav = batch["wav"]
    mel_in = batch.get("mel")
    if mel_in is None:
        mel_in = mel_spectrogram(wav, **cfg)
    x_in = mel_in.transpose(1, 2).to(dtype)  # the generator's (B, n_mels, T)
    wav_c = wav.to(dtype)

    # 1-2: the discriminators' update on the generator's output, without a graph
    with torch.no_grad():
        y_hat = _runner(gen, bf16, trainable=False)(x_in)[:, 0]
    for group in opt_d.param_groups:
        for p in group["params"]:
            p.grad = None
    world = distributed.process_count()
    run_mpd, run_msd = _runner(mpd, bf16, True), _runner(msd, bf16, True)
    loss_f = discriminator_loss(run_mpd(wav_c)[0], run_mpd(y_hat)[0])[0]
    loss_s = discriminator_loss(run_msd(wav_c)[0], run_msd(y_hat)[0])[0]
    loss_d = (loss_f + loss_s).float()
    (loss_d / world).backward()  # this rank's share of the global mean
    allreduce_grads(p for group in opt_d.param_groups for p in group["params"])
    opt_d.step()

    # 3-4: the generator's update against the updated discriminators
    for p in gen.parameters():
        p.grad = None
    y_g = _runner(gen, bf16, trainable=True)(x_in)[:, 0]
    with torch.no_grad():
        mel_t = mel_spectrogram(wav, **loss_cfg)
    loss_mel = MEL_LOSS_WEIGHT * torch.mean(torch.abs(mel_spectrogram(y_g, **loss_cfg) - mel_t))
    run_mpd, run_msd = _runner(mpd, bf16, False), _runner(msd, bf16, False)
    with torch.no_grad():
        fr, fr_s = run_mpd(wav_c)[1], run_msd(wav_c)[1]
    pg, fg = run_mpd(y_g)
    sg, fg_s = run_msd(y_g)
    loss_fm = feature_loss(fr, fg) + feature_loss(fr_s, fg_s)
    adv = generator_loss(pg)[0] + generator_loss(sg)[0]
    loss_g = (adv + loss_fm).float() + loss_mel
    (loss_g / world).backward()
    allreduce_grads(gen.parameters())
    opt_g.step()
    metrics = [loss_g, loss_d, loss_mel / MEL_LOSS_WEIGHT, loss_fm.float(), adv.float(),
               loss_f.float(), loss_s.float()]
    if world > 1:  # the global means: the local ones over N, summed
        metrics = global_metrics(*(m / world for m in metrics))
    names = ("loss_gen", "loss_disc", "mel_error", "loss_fm", "loss_adv", "loss_disc_mpd",
             "loss_disc_msd")
    return {k: v.detach() for k, v in zip(names, metrics)}


class HiFiGANTrainer:
    """The epoch driver: the GAN step, train.log, TensorBoard, validation,
    checkpoints, resume."""

    def __init__(self, gen: Generator, mpd: MultiPeriodDiscriminator,
                 msd: MultiScaleDiscriminator, log_dir: str, mel_cfg: Optional[dict] = None,
                 learning_rate: float = 2e-4, adam_b1: float = 0.8, adam_b2: float = 0.99,
                 lr_decay: float = 0.999, steps_per_epoch: int = 1, save_every: int = 5,
                 bf16: bool = False, exp=None, datasets: Sequence = ()):
        """The models on their training device. exp: an optional
        ``utils/exp_manager.py::ExpManager`` that owns the log dir and the
        TensorBoard writer. datasets: the ``MelAudioDataset``s whose crop
        generators the checkpoints keep."""
        self.gen = gen
        self.disc = nn.ModuleDict({"mpd": mpd, "msd": msd})
        self.device = next(gen.parameters()).device
        self.rank, self.world = distributed.process_index(), distributed.process_count()
        self.primary = self.rank == 0
        for module in (gen, self.disc):
            replicate(module)  # rank 0's weights (nothing at world 1)
        self.exp = exp
        self.log_dir = exp.log_dir if exp is not None else log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.mel_cfg = dict(MEL_CFG, **(mel_cfg or {}))
        self.opt_g, self.opt_d = make_optimizers(gen, self.disc, learning_rate, adam_b1,
                                                 adam_b2, lr_decay, steps_per_epoch)
        self.bf16 = bf16
        self.datasets = list(datasets)
        self.ckpt = Checkpointer(os.path.join(self.log_dir, "ckpt"))
        self.save_every = save_every
        self.tb = exp.tb if exp is not None and self.primary else None
        self.timer = StepTimer()
        self.iteration = 0
        self.epoch = -1  # the last epoch whose end was reached
        self._saved_step = None

    def step(self, batch: dict) -> dict:
        """One GAN step on a device batch."""
        return gan_train_step(self.gen, self.disc["mpd"], self.disc["msd"], self.opt_g,
                              self.opt_d, batch, self.mel_cfg, self.bf16)

    def state(self) -> dict:
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict(),
                "opt_g": optimizer_state(self.gen, self.opt_g),
                "opt_d": optimizer_state(self.disc, self.opt_d),
                "step": self.iteration, "epoch": self.epoch,
                "data_rngs": [ds.rng.bit_generator.state for ds in self.datasets]}

    def load_state(self, state: dict) -> None:
        self.gen.load_state_dict(state["gen"])
        self.disc.load_state_dict(state["disc"])
        load_optimizer_state(self.gen, self.opt_g, state["opt_g"])
        load_optimizer_state(self.disc, self.opt_d, state["opt_d"])
        self.iteration, self.epoch = int(state["step"]), int(state["epoch"])
        self._saved_step = self.iteration
        for ds, rng_state in zip(self.datasets, state["data_rngs"]):
            ds.rng.bit_generator.state = rng_state

    def resume_if_exists(self) -> bool:
        state = self.ckpt.restore_latest()
        if state is None:
            return False
        self.load_state(state)
        return True

    def train_epoch(self, loader, epoch: int) -> dict:
        """One pass over ``loader``; the ``train.log`` line of
        ``train/hifigan.py:281-290``. Returns the means of loss_gen,
        loss_disc and mel_error."""
        self.gen.train()
        agg = {"loss_gen": [], "loss_disc": [], "mel_error": []}
        t0 = time.time()
        n_samples = 0
        for batch in loader:
            n_samples += int(np.asarray(batch["wav"]).shape[0])
            if self.world > 1:
                batch = shard_batch(batch, self.rank, self.world)
            batch = batch_to_device(batch, self.device)
            self.timer.tick("step")
            metrics = self.step(batch)
            # one read of every metric: the sync that closes the step
            m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            self.timer.tock("step")
            if self.tb is not None and self.iteration % 10 == 0:
                for k, v in m.items():
                    self.tb.add_scalar(f"training/{k}", v, self.iteration)
                st = self.timer.summary().get("step")
                if st is not None:
                    self.tb.add_scalar("training/step_time_ms", st["mean_s"] * 1e3,
                                       self.iteration)
            for k in agg:
                agg[k].append(m[k])
            self.iteration += 1

        dt = time.time() - t0
        means = {k: float(np.mean(v)) if v else float("nan") for k, v in agg.items()}
        msg = ("Epoch %d: gen loss = %.3f | disc loss = %.3f | mel error = %.4f | %.1f utt/s\n"
               % (epoch, means["loss_gen"], means["loss_disc"], means["mel_error"],
                  n_samples / max(dt, 1e-9)))
        if self.primary:
            with open(os.path.join(self.log_dir, "train.log"), "a") as f:
                f.write(msg)
        return means

    def end_epoch(self, epoch: int) -> None:
        """Mark ``epoch`` done; a checkpoint every ``save_every`` epochs
        (``epoch % save_every == 0``)."""
        self.epoch = epoch
        if epoch % self.save_every == 0:
            self.save()

    def save(self) -> None:
        """A checkpoint of this step, unless one was written at it."""
        if self._saved_step != self.iteration:
            if self.primary:
                self.ckpt.save(self.iteration, self.state())
            self._saved_step = self.iteration

    @torch.no_grad()
    def validate(self, loader, max_batches: int = 8, log_audio: int = 0) -> float:
        """The full-band mel L1 of the fp32 generator on at most
        ``max_batches`` batches; the first ``log_audio`` generated wavs to
        TensorBoard (``train/hifigan.py:301``), or as wav files in the log
        dir where TensorBoard cannot take them."""
        loss_cfg = dict(self.mel_cfg, fmax=self.mel_cfg["sampling_rate"] / 2.0)
        errs, logged = [], 0
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            batch = batch_to_device(batch, self.device)
            wav = batch["wav"]
            mel = batch.get("mel")
            if mel is None:
                mel = mel_spectrogram(wav, **self.mel_cfg)
            y_g = self.gen(mel.transpose(1, 2))[:, 0]
            err = torch.mean(torch.abs(mel_spectrogram(y_g, **loss_cfg)
                                       - mel_spectrogram(wav, **loss_cfg)))
            errs.append(float(err))
            if logged < log_audio and self.primary:
                y = y_g.float().cpu().numpy()
                for j in range(min(log_audio - logged, y.shape[0])):
                    self._log_audio(f"gen_audio_{logged}", y[j])
                    logged += 1
        val = float(np.mean(errs)) if errs else float("nan")
        if self.tb is not None:
            self.tb.add_scalar("validation/mel_error", val, self.iteration)
        return val

    def _log_audio(self, name: str, wav: np.ndarray) -> None:
        """A generated wav to TensorBoard; without a writer, or where
        tensorboardX cannot encode audio (it needs ``soundfile``), as
        ``<log_dir>/<name>.wav``."""
        if self.tb is not None and importlib.util.find_spec("soundfile") is not None:
            self.tb.add_audio(f"validation/{name}", wav[:, None], self.iteration,
                              sample_rate=self.mel_cfg["sampling_rate"])
        else:
            write_wav(os.path.join(self.log_dir, f"{name}.wav"), wav,
                      self.mel_cfg["sampling_rate"])

    def save_generator(self, name: str = "generator") -> str:
        """``<log_dir>/<name>.pt``: ``{"generator": state_dict}`` with the
        reference's names, which both inference CLIs' ``load_hifigan`` read."""
        path = os.path.join(self.log_dir, f"{name}.pt")
        if self.primary:
            torch.save({"generator": {k: v.detach().cpu() for k, v in
                                      self.gen.state_dict().items()}}, path)
        distributed.barrier()
        return path
