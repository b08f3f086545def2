"""Grad-TTS training: the step and the epoch loop.

The port's counterpart of ``tpu_speech/train/gradtts.py`` (the reference loop
Grad-TTS/train.py:97-175). ``train_step`` is ``make_train_step:29``'s step:
the loss (encoder, log-prior, MAS on the hand CUDA kernel, duration loss, the
random ``out_size`` crop, diffusion and prior losses), backward, the encoder
and the estimator clipped separately to norm 1 (``spk_emb`` left unclipped,
as the JAX step leaves it), then Adam (``AdamW`` with ``weight_decay = 0``,
which is ``optax.adam`` step for step). It makes no host sync. Its draws (t,
z, the crop offsets) come from a ``torch.Generator`` on the batch's device,
seeded per step from (seed, iteration) by ``step_generator``: the
counterpart of ``fold_in(base_rng, iteration)`` (``:231``), so a resumed run
draws what a straight run would. Dropout stays on torch's default generator,
whose state the checkpoint keeps.

``GradTTSTrainer`` (``:86-274``) runs epochs: the ``train.log`` line per
epoch, TensorBoard scalars every 10 steps, a checkpoint every ``save_every``
epochs (``utils/checkpoint.py``: the model, Adam's moments and count, the
step), ``resume_if_exists``, synthesis previews, and at the end
``save_state_dict``: a reference-named ``.pt`` (the reference's own
checkpoint format, Grad-TTS/train.py:174-175) that ``cli/inference.py``
loads.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_speech_torch.models.grad_tts import GradTTS, synthesize
from tpu_speech_torch.train.optim import AdamW, clip_subtree_by_global_norm
from tpu_speech_torch.utils.checkpoint import Checkpointer
from tpu_speech_torch.utils.profiling import StepTimer

ENCODER = ("encoder.",)
ESTIMATOR = ("decoder.estimator.",)
MAX_GRAD_NORM = 1.0  # per module (Grad-TTS/train.py:115-118)
PREVIEW_TIMESTEPS = 50  # reverse-diffusion steps of the synthesis previews
PREVIEW_MAX_FRAMES = 512  # their mel length


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of one step's t, z and crop offsets, on ``device``,
    seeded from (seed, iteration)."""
    return torch.Generator(device).manual_seed((seed << 32) + iteration)


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch of ``TextMelBatchCollate`` -> tensors on ``device``
    (through pinned memory for a CUDA device)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def train_step(model: GradTTS, opt: AdamW, batch: dict,
               generator: Optional[torch.Generator] = None, out_size: Optional[int] = None,
               offsets=None, t=None, z=None, attn=None) -> dict:
    """One update of ``model`` in place from a device batch (``x``,
    ``x_lengths``, ``y`` (B, Ty, F), ``y_lengths``, optional ``spk``).
    ``offsets``, ``t``, ``z`` and ``attn`` replace the draws and the MAS
    path (``GradTTS.forward``). Returns the JAX package's metrics as 0-d
    device tensors: loss, dur_loss, prior_loss, diff_loss and the pre-clip
    enc_grad_norm and dec_grad_norm."""
    params = list(model.named_parameters())
    for _, p in params:
        p.grad = None
    dur, prior, diff = model(batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
                             spk=batch.get("spk"), out_size=out_size, generator=generator,
                             offsets=offsets, t=t, z=z, attn=attn)
    loss = dur + prior + diff
    loss.backward()
    for _, p in params:
        if p.grad is None:  # a leaf the loss does not reach: JAX's gradient is zero
            p.grad = torch.zeros_like(p)
    enc_norm = clip_subtree_by_global_norm(params, ENCODER, MAX_GRAD_NORM)
    dec_norm = clip_subtree_by_global_norm(params, ESTIMATOR, MAX_GRAD_NORM)
    opt.step()
    return {"loss": loss.detach(), "dur_loss": dur.detach(), "prior_loss": prior.detach(),
            "diff_loss": diff.detach(), "enc_grad_norm": enc_norm, "dec_grad_norm": dec_norm}


class GradTTSTrainer:
    """The epoch loop: train.log, TensorBoard, checkpoints, resume, previews
    (mel and alignment images, Grad-TTS/train.py:142-175)."""

    def __init__(self, model: GradTTS, log_dir: str, learning_rate: float = 1e-4,
                 out_size: Optional[int] = None, save_every: int = 1, seed: int = 0, exp=None,
                 preview_batch=None):
        """model: on its training device. exp: an optional
        ``utils/exp_manager.py::ExpManager`` that owns the log dir and the
        TensorBoard writer. preview_batch: a dict of padded int32 ``x`` (B,
        Tx) and ``x_lengths`` (and ``spk``) for the per-epoch synthesis
        previews the reference logs as its de facto integration test."""
        self.model = model
        self.device = next(model.parameters()).device
        self.exp = exp
        self.log_dir = exp.log_dir if exp is not None else log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.opt = AdamW(model.parameters(), learning_rate)
        self.out_size = out_size
        self.seed = seed
        self.ckpt = Checkpointer(os.path.join(self.log_dir, "ckpt"))
        self.save_every = save_every
        self.tb = exp.tb if exp is not None else None
        self.preview_batch = preview_batch
        self.timer = StepTimer()
        self.iteration = 0

    def state(self) -> dict:
        """What a checkpoint holds: the model's state_dict, Adam's moments
        (by parameter name) and count, the step, and the state of torch's
        default generator (and the device's, on a card), which dropout
        draws from."""
        names = {p: n for n, p in self.model.named_parameters()}
        st = self.opt.state
        out = {"model": self.model.state_dict(),
               "mu": {names[p]: s["mu"] for p, s in st.items()},
               "nu": {names[p]: s["nu"] for p, s in st.items()},
               "count": self.opt.count, "step": self.iteration,
               "rng_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            out["rng_cuda"] = torch.cuda.get_rng_state(self.device)
        return out

    def load_state(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        for name, p in self.model.named_parameters():
            if name in state["mu"]:
                self.opt.state[p] = {"mu": state["mu"][name].to(p.device),
                                     "nu": state["nu"][name].to(p.device)}
        self.opt.count = int(state["count"])
        self.iteration = int(state["step"])
        torch.set_rng_state(state["rng_cpu"])
        if self.device.type == "cuda" and "rng_cuda" in state:
            torch.cuda.set_rng_state(state["rng_cuda"], self.device)

    def resume_if_exists(self) -> bool:
        state = self.ckpt.restore_latest()
        if state is None:
            return False
        self.load_state(state)
        return True

    def save_state_dict(self, name: str = "gradtts") -> str:
        """The final weights, reference-named, as ``<log_dir>/<name>.pt``."""
        path = os.path.join(self.log_dir, f"{name}.pt")
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, path)
        return path

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
            batch = batch_to_device(batch, self.device)
            self.timer.tick("step")
            metrics = train_step(self.model, self.opt, batch, generator, self.out_size)
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
        with open(os.path.join(self.log_dir, "train.log"), "a") as f:
            f.write(msg)
        if epoch % self.save_every == 0:
            self.ckpt.save(self.iteration, self.state())
            self.log_previews(epoch)
        return means
