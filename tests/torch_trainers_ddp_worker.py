"""The ranks of ``tests/test_torch_trainers_ddp.py``: four gloo processes on
the CPU.

``run(rank, root)`` reads ``root/job.pt`` (the tiny models' weights, the
global batches and the JAX draws the test made from numpy seeds). The four
ranks join a process group at a ``file://`` store under ``root`` and run the
trainers' steps of ``job["checks4"]`` on their row of each global batch;
then ranks 0-1 join a two-rank group at another store and run every check
of ``CHECKS`` on their rows. Each saves what it saw to ``root/rank<r>.pt``
(the world of four's under ``"w4"``). A check called with world 1 is the
one-process run on the whole global batch. It imports torch and the port
only.
"""

from __future__ import annotations

import os
import time

import torch

from tpu_speech_torch.models.diffvc import DiffVC, FwdDiffusion
from tpu_speech_torch.models.grad_tts import GradTTS
from tpu_speech_torch.models.hifigan import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from tpu_speech_torch.parallel import distributed, launch, mesh
from tpu_speech_torch.train import diffvc as t_diffvc
from tpu_speech_torch.train import gradtts as t_gradtts
from tpu_speech_torch.train import hifigan as t_hifigan
from tpu_speech_torch.train.gradtts import GradTTSTrainer
from tpu_speech_torch.train.optim import AdamW
from tpu_speech_torch.train.trainer import batch_to_device, step_generator


def _rows(x, rank, world):
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def _host(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def _adam(module, job):
    return AdamW(module.parameters(), job["lr"], eps=job["eps"])


def _gradtts(job, rank, world, n_spks, draws):
    """One Grad-TTS step (MAS on) on this rank's rows: ``draws`` "jax"
    replays the JAX step's global offsets, t and z (this rank's rows);
    "own" draws from the step generator at the global shape."""
    model = GradTTS(**dict(job["tts_cfg"], n_spks=n_spks)).eval()
    model.load_state_dict(job[f"tts_sd{n_spks}"], strict=True)
    mesh.replicate(model)
    opt = _adam(model, job)
    batch = job[f"tts_batch{n_spks}"]
    kw = {}
    if draws == "jax":
        offsets, t, z = job[f"tts_draws{n_spks}"]
        kw = dict(offsets=_rows(offsets, rank, world), t=_rows(t, rank, world),
                  z=_rows(z, rank, world))
    m = t_gradtts.train_step(model, opt, batch_to_device(mesh.shard_batch(batch, rank, world),
                                                          "cpu"),
                             step_generator(job["seed"], 0, "cpu"), job["out_size"], **kw)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": _grads(model),
            "sd": _host(model)}


def _hifigan(job, rank, world):
    """One GAN step on this rank's rows, ``make_optimizers`` at the test's
    lr."""
    gen = Generator(**job["hg_gen"])
    mpd = MultiPeriodDiscriminator(*job["hg_mpd"])
    msd = MultiScaleDiscriminator(*job["hg_msd"])
    disc = torch.nn.ModuleDict({"mpd": mpd, "msd": msd})
    gen.load_state_dict(job["hg_gen_sd"], strict=True)
    disc.load_state_dict(job["hg_disc_sd"], strict=True)
    for module in (gen, disc):
        mesh.replicate(module)
    opt_g, opt_d = t_hifigan.make_optimizers(gen, disc, job["hg_lr"], steps_per_epoch=1)
    batch = batch_to_device(mesh.shard_batch(job["hg_batch"], rank, world), "cpu")
    m = t_hifigan.gan_train_step(gen, mpd, msd, opt_g, opt_d, batch, job["hg_mel"])
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": _grads(gen),
            "disc_grads": _grads(disc), "sd": _host(gen), "disc_sd": _host(disc)}


def _diffvc_enc(job, rank, world):
    model = FwdDiffusion(**job["enc_cfg"]).eval()
    model.load_state_dict(job["enc_sd"], strict=True)
    mesh.replicate(model)
    opt = _adam(model, job)
    m = t_diffvc.enc_train_step(model, opt, batch_to_device(
        mesh.shard_batch(job["enc_batch"], rank, world), "cpu"))
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": _grads(model),
            "sd": _host(model)}


def _diffvc_dec(job, rank, world, draws):
    model = DiffVC(**job["vc_cfg"])
    model.load_state_dict(job["vc_sd"], strict=True)
    mesh.replicate(model)
    opt = _adam(model, job)
    kw = {}
    if draws == "jax":
        t, z = job["vc_draws"]
        kw = dict(t=_rows(t, rank, world), z=_rows(z, rank, world))
    m = t_diffvc.dec_train_step(model, opt, batch_to_device(
        mesh.shard_batch(job["vc_batch"], rank, world), "cpu"),
        step_generator(job["seed"], 0, "cpu"), **kw)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": _grads(model),
            "sd": _host(model)}


def _streams(job, rank, world):
    """Dropout's default generator after a trainer is built: rank 0 keeps
    the one-process stream, the others differ."""
    torch.manual_seed(job["seed"])
    GradTTSTrainer(GradTTS(**dict(job["tts_cfg"], n_spks=1)),
                   os.path.join(job["root"], "streams"), seed=job["seed"])
    return {"draw": torch.rand(8)}


def _trainer_checkpoint(job, rank, world):
    """A GradTTSTrainer over two epochs of two global batches, a checkpoint
    each epoch (written by rank 0, every rank's generators in it)."""
    torch.manual_seed(job["seed"])
    model = GradTTS(**dict(job["tts_cfg"], n_spks=1))
    log_dir = os.path.join(job["root"], f"ckpt_w{world}")
    trainer = GradTTSTrainer(model, log_dir, learning_rate=job["lr"], out_size=job["out_size"],
                             seed=job["seed"])
    loader = [job["tts_batch1"], job["tts_batch1_b"]]
    losses = [trainer.train_epoch(loader, epoch) for epoch in (1, 2)]
    trainer.ckpt.wait()
    return {"dir": log_dir, "losses": losses, "sd": _host(model),
            "iteration": trainer.iteration}


def _clis(job, rank, world):
    """The Grad-TTS and DiffVC decoder CLIs inside this group: each rank
    joins through ``launch`` and rank 0 writes the reference-named ``.pt``."""
    from tpu_speech_torch.cli import train as train_cli
    from tpu_speech_torch.cli import train_dec

    launch.apply_snapshot(job["cli_config"])
    init = "file://" + os.path.join(job["root"], "store")
    tts = train_cli.main(["--device", "cpu"], _init_method=init)
    dec = train_dec.main(job["dec_argv"], _init_method=init)
    return {"tts": {k: tts[k] for k in ("iteration", "state_dict", "epochs")},
            "dec": {k: dec[k] for k in ("iteration", "state_dict", "losses")}}


CHECKS = {
    "gradtts1": lambda j, r, w: _gradtts(j, r, w, 1, "own"),
    "gradtts3": lambda j, r, w: _gradtts(j, r, w, 3, "own"),
    "gradtts1_jax": lambda j, r, w: _gradtts(j, r, w, 1, "jax"),
    "gradtts3_jax": lambda j, r, w: _gradtts(j, r, w, 3, "jax"),
    "hifigan": _hifigan,
    "diffvc_enc": _diffvc_enc,
    "diffvc_dec": lambda j, r, w: _diffvc_dec(j, r, w, "own"),
    "diffvc_dec_jax": lambda j, r, w: _diffvc_dec(j, r, w, "jax"),
    "streams": _streams,
    "ckpt": _trainer_checkpoint,
    "clis": _clis,
}


def _in_group(job, rank, world, store, checks) -> dict:
    distributed.initialize(num_processes=world, process_id=rank, device="cpu",
                           init_method="file://" + os.path.join(job["root"], store))
    try:
        return {name: CHECKS[name](job, rank, world) for name in checks}
    finally:
        distributed.shutdown()


def run(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(os.path.join(root, "job.pt"), weights_only=False)
    out = {"w4": _in_group(job, rank, 4, "store4", job["checks4"])}
    if rank < job["world"]:
        out.update(_in_group(job, rank, job["world"], "store", job["checks"]))
    out["finished"] = time.time()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
