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
defaults to ``cuda`` and raises without a card. fp32 only: the config's
``precision = "bf16"`` raises (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.data.gradtts import TextMelBatchCollate, TextMelDataset
from tpu_speech_torch.data.loader import DataLoader
from tpu_speech_torch.models.grad_tts import GradTTS
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


def main(argv=None, multispeaker: bool = False) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if cfg.precision != "fp32":
        raise NotImplementedError(f"precision {cfg.precision!r}: Grad-TTS training runs in "
                                  "fp32; bf16 is not ported yet (ROADMAP.md, Queue 1)")
    name = "gradtts_multi" if multispeaker else "gradtts"
    exp = ExpManager(name=name, explicit_log_dir=cfg.log_dir)
    exp.save_config({k: v for k, v in vars(cfg).items() if not k.startswith("_")
                     and isinstance(v, (int, float, str, bool, list, tuple))})

    print("Initializing data loaders...")
    dataset = TextMelDataset(
        cfg.train_filelist_path, cfg.cmudict_path, cfg.add_blank, cfg.n_fft, cfg.n_feats,
        cfg.sample_rate, cfg.hop_length, cfg.win_length, cfg.f_min, cfg.f_max,
        multispeaker=multispeaker, shuffle_seed=cfg.seed)
    loader = DataLoader(dataset, cfg.batch_size, TextMelBatchCollate(), shuffle=False,
                        drop_last=True, num_workers=4, seed=cfg.seed)

    print("Initializing model...")
    model = build_model(cfg.n_spks if multispeaker else None).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total parameters: {n_params / 1e6:.2f}m")

    trainer = GradTTSTrainer(
        model, cfg.log_dir, learning_rate=cfg.learning_rate, out_size=cfg.out_size,
        save_every=cfg.save_every, seed=cfg.seed, exp=exp,
        preview_batch=build_preview_batch(dataset, cfg.test_filelist_path, multispeaker))
    first_epoch = 1
    if trainer.resume_if_exists():
        first_epoch = trainer.iteration // max(len(loader), 1) + 1
        print(f"Resumed from iteration {trainer.iteration}")

    print("Start training...")
    epochs = []
    for epoch in range(first_epoch, cfg.n_epochs + 1):
        stats = trainer.train_epoch(loader, epoch)
        epochs.append(stats)
        print(f"Epoch {epoch}: dur {stats['dur_loss']:.3f} | prior {stats['prior_loss']:.3f} "
              f"| diff {stats['diff_loss']:.3f}")
    trainer.ckpt.wait()  # drain the last checkpoint write
    path = trainer.save_state_dict(name)
    print(f"saved model: {path}")
    exp.close()
    return {"n_params": n_params, "iteration": trainer.iteration, "first_epoch": first_epoch,
            "epochs": epochs, "state_dict": path, "log_dir": trainer.log_dir}


if __name__ == "__main__":
    main()
