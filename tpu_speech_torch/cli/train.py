"""Grad-TTS training CLI: the port's counterpart of ``cli/train.py`` (the
reference Grad-TTS/train.py:59-175).

    python -m tpu_speech_torch.cli.train [--device cpu]
    python -m tpu_speech_torch.cli.train_multi_speaker [--device cpu]

The settings are ``tpu_speech_torch/configs/gradtts.py``'s, as the JAX CLI's
are ``cli/params.py``'s: the filelist (``wav_path|text``, and ``|speaker`` for
the multi-speaker entry) -> mels and ids on host threads -> padded batches ->
``train/gradtts.py::train_step`` on the device (MAS on the hand CUDA kernel)
-> ``train.log``, TensorBoard, a checkpoint every ``save_every`` epochs in
``<log_dir>/ckpt``. A run on a log dir that holds checkpoints resumes from
the latest one, at the epoch after it. At the end it writes
``<log_dir>/gradtts.pt`` (``gradtts_multi.pt``), a reference-named
state_dict that ``tpu_speech_torch.cli.inference -c`` loads. ``--device``
defaults to ``cuda`` and raises without a card. The config's ``precision =
"bf16"`` trains with the mixed-precision step (float32 masters, bf16
forward and backward), as the JAX CLI reads it (``cli/train.py:111``); any
other value trains in fp32.

Several cards (``parallel/launch.py``): the command starts one rank per
visible card (``CUDA_VISIBLE_DEVICES`` picks them), as the JAX CLI's
``make_mesh()`` spans every local device; ``batch_size`` is the global
batch, split into equal contiguous rows (it must divide by the ranks), and
the step is the one-process step on the global batch. ``torchrun
--nproc_per_node N -m tpu_speech_torch.cli.train`` works too, and so do N
gloo ranks on the CPU (``torchrun ... --device cpu``). Rank 0 alone writes
the log dir's files.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.data.gradtts import TextMelBatchCollate, TextMelDataset
from tpu_speech_torch.data.loader import DataLoader
from tpu_speech_torch.models.grad_tts import GradTTS
from tpu_speech_torch.parallel import distributed, launch
from tpu_speech_torch.text import symbols
from tpu_speech_torch.train.gradtts import GradTTSTrainer
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.exp_manager import ExpManager


def build_model(n_spks=None) -> GradTTS:
    """GradTTS at the config's width with the reference's initialisation
    (each module's PyTorch default), drawn after ``torch.manual_seed(seed)``;
    dropout then draws from the same default generator."""
    kwargs = cfg.model_kwargs(len(symbols) + 1 if cfg.add_blank else len(symbols))
    kwargs["n_spks"] = n_spks or cfg.n_spks
    torch.manual_seed(cfg.seed)
    return GradTTS(**kwargs)


def build_preview_batch(dataset, filelist_path, multispeaker, n=3):
    """Fixed synthesis-preview sentences from the test filelist (the
    reference test_batch, Grad-TTS/train.py:85-95); None without one."""
    try:
        with open(filelist_path, encoding="utf-8") as f:
            lines = [ln.strip().split("|") for ln in f if ln.strip()][:n]
    except OSError:
        return None
    if not lines:
        return None
    seqs = [dataset.get_text(parts[1]) for parts in lines]
    x = np.zeros((len(seqs), max(len(s) for s in seqs)), dtype=np.int32)
    for i, s in enumerate(seqs):
        x[i, : len(s)] = s
    batch = {"x": x, "x_lengths": np.array([len(s) for s in seqs], dtype=np.int32)}
    if multispeaker:
        batch["spk"] = np.array([int(parts[2]) if len(parts) > 2 else 0 for parts in lines],
                                dtype=np.int32)
    return batch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU")
    return parser


def main(argv=None, multispeaker: bool = False, _init_method=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if multispeaker:
        from tpu_speech_torch.cli.train_multi_speaker import main as entry
    else:
        entry = main
    spawned, out = launch.launch(entry, argv, args.device, _init_method, modules=(cfg,))
    if spawned:
        return out
    device = distributed.rank_device(resolve_device(args.device))
    launch.check_batch(cfg.batch_size)
    name = "gradtts_multi" if multispeaker else "gradtts"
    exp = ExpManager(name=name, explicit_log_dir=cfg.log_dir)
    exp.save_config({k: v for k, v in vars(cfg).items() if not k.startswith("_")
                     and isinstance(v, (int, float, str, bool, list, tuple))})

    launch.say("Initializing data loaders...")
    dataset = TextMelDataset(
        cfg.train_filelist_path, cfg.cmudict_path, cfg.add_blank, cfg.n_fft, cfg.n_feats,
        cfg.sample_rate, cfg.hop_length, cfg.win_length, cfg.f_min, cfg.f_max,
        multispeaker=multispeaker, shuffle_seed=cfg.seed)
    loader = DataLoader(dataset, cfg.batch_size, TextMelBatchCollate(), shuffle=False,
                        drop_last=True, num_workers=4, seed=cfg.seed)

    launch.say("Initializing model...")
    model = build_model(cfg.n_spks if multispeaker else None).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    launch.say(f"Total parameters: {n_params / 1e6:.2f}m")

    trainer = GradTTSTrainer(
        model, cfg.log_dir, learning_rate=cfg.learning_rate, out_size=cfg.out_size,
        save_every=cfg.save_every, seed=cfg.seed, exp=exp,
        bf16=getattr(cfg, "precision", "fp32") == "bf16",
        preview_batch=build_preview_batch(dataset, cfg.test_filelist_path, multispeaker))
    first_epoch = 1
    if trainer.resume_if_exists():
        first_epoch = trainer.iteration // max(len(loader), 1) + 1
        launch.say(f"Resumed from iteration {trainer.iteration}")

    launch.say("Start training...")
    epochs = []
    for epoch in range(first_epoch, cfg.n_epochs + 1):
        stats = trainer.train_epoch(loader, epoch)
        epochs.append(stats)
        launch.say(f"Epoch {epoch}: dur {stats['dur_loss']:.3f} | prior {stats['prior_loss']:.3f} "
              f"| diff {stats['diff_loss']:.3f}")
    trainer.ckpt.wait()  # drain the last checkpoint write
    path = trainer.save_state_dict(name)
    launch.say(f"saved model: {path}")
    exp.close()
    return {"n_params": n_params, "iteration": trainer.iteration, "first_epoch": first_epoch,
            "epochs": epochs, "state_dict": path, "log_dir": trainer.log_dir}


if __name__ == "__main__":
    main()
