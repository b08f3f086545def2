"""HiFi-GAN vocoder training CLI: the port's counterpart of
``cli/train_hifigan.py`` (the upstream V1 recipe: generator + MPD/MSD
adversarial training with feature matching and the on-device mel loss).

    python -m tpu_speech_torch.cli.train_hifigan --config hifigan-config.json \\
        --input_training_file train.txt [--input_wavs_dir D] \\
        [--input_validation_file val.txt] [--fine_tuning --input_mels_dir M] \\
        [--log_dir logs/hifigan] [--training_epochs 100] [--validation_interval 5] \\
        [--resume_if_exists] [--bf16] [--num_workers 4] [--device cpu]

The config is the upstream JSON (``hifigan-config.json``'s keys; missing
keys take V1's values). The filelists hold one wav id or path per line
(everything past '|' is ignored). Epochs count from 0: validation runs at
``epoch % validation_interval == 0``, a checkpoint is written to
``<log_dir>/ckpt`` every 5 epochs (after the epoch's validation) and at the
end, and ``--resume_if_exists`` continues from the latest one at the epoch
after it. At the end the generator is also written as
``<log_dir>/generator.pt``, ``{"generator": state_dict}`` with the
reference's names, which ``tpu_speech_torch.cli.inference --hifigan`` and
the JAX CLI load. ``--device`` defaults to ``cuda`` and raises without a
card.

Several cards (``parallel/launch.py``): one rank per visible card, the
config's ``batch_size`` the global batch (it must divide by the ranks), the
step the one-process step on the global batch; torchrun's variables and N
gloo ranks on the CPU work too. Rank 0 alone writes the log dir's files.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tpu_speech_torch.data.hifigan import MelAudioBatchCollate, MelAudioDataset, load_wav_files
from tpu_speech_torch.data.loader import DataLoader
from tpu_speech_torch.models.hifigan import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    uniform_init_,
)
from tpu_speech_torch.parallel import distributed, launch
from tpu_speech_torch.train.hifigan import HiFiGANTrainer
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.exp_manager import ExpManager


def build_generator(h: dict) -> Generator:
    """The generator of a config (``cli/train_hifigan.py:35``)."""
    return Generator(
        resblock=str(h.get("resblock", "1")),
        upsample_rates=tuple(h.get("upsample_rates", (8, 8, 2, 2))),
        upsample_kernel_sizes=tuple(h.get("upsample_kernel_sizes", (16, 16, 4, 4))),
        upsample_initial_channel=int(h.get("upsample_initial_channel", 512)),
        resblock_kernel_sizes=tuple(h.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in h.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
        n_mels=int(h.get("num_mels", 80)),
    )


def build_models(h: dict):
    """The generator of the config and the V1 discriminators with the JAX
    package's uniform init (as ``HiFiGANTrainer`` inits its three trees),
    drawn in that order from one generator seeded with the config's
    ``seed``; on the CPU."""
    init = torch.Generator().manual_seed(int(h.get("seed", 1234)))
    return (uniform_init_(build_generator(h), init),
            MultiPeriodDiscriminator().init_weights(init),
            MultiScaleDiscriminator().init_weights(init))


def mel_cfg_from(h: dict) -> dict:
    """The mel settings of a config (``cli/train_hifigan.py:49``)."""
    return dict(
        n_fft=int(h.get("n_fft", 1024)),
        num_mels=int(h.get("num_mels", 80)),
        sampling_rate=int(h.get("sampling_rate", 22050)),
        hop_size=int(h.get("hop_size", 256)),
        win_size=int(h.get("win_size", 1024)),
        fmin=float(h.get("fmin", 0.0)),
        fmax=float(h.get("fmax", 8000.0)),
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, required=True,
                   help="HiFi-GAN JSON config (hifigan-config.json keys)")
    p.add_argument("--input_wavs_dir", type=str, default="")
    p.add_argument("--input_training_file", type=str, required=True)
    p.add_argument("--input_validation_file", type=str, default=None)
    p.add_argument("--input_mels_dir", type=str, default=None)
    p.add_argument("--fine_tuning", action="store_true")
    p.add_argument("--log_dir", type=str, default="logs/hifigan")
    p.add_argument("--training_epochs", type=int, default=100)
    p.add_argument("--validation_interval", type=int, default=5)
    p.add_argument("--resume_if_exists", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def main(argv=None, _init_method=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    spawned, out = launch.launch(main, argv, args.device, _init_method)
    if spawned:
        return out
    device = distributed.rank_device(resolve_device(args.device))
    with open(args.config, encoding="utf-8") as f:
        h = json.load(f)
    mel_cfg = mel_cfg_from(h)
    segment = int(h.get("segment_size", 8192))
    batch_size = int(h.get("batch_size", 16))
    launch.check_batch(batch_size)
    seed = int(h.get("seed", 1234))

    train_ds = MelAudioDataset(
        load_wav_files(args.input_training_file, args.input_wavs_dir), segment_size=segment,
        sampling_rate=mel_cfg["sampling_rate"], fine_tuning=args.fine_tuning,
        input_mels_dir=args.input_mels_dir, hop_size=mel_cfg["hop_size"], seed=seed)
    loader = DataLoader(train_ds, batch_size, MelAudioBatchCollate(),
                        num_workers=args.num_workers)
    datasets, val_loader = [train_ds], None
    if args.input_validation_file:
        # no seed, as the JAX CLI builds it: the dataset's default 1234
        val_ds = MelAudioDataset(
            load_wav_files(args.input_validation_file, args.input_wavs_dir),
            segment_size=segment, sampling_rate=mel_cfg["sampling_rate"],
            fine_tuning=args.fine_tuning, input_mels_dir=args.input_mels_dir,
            hop_size=mel_cfg["hop_size"])
        val_loader = DataLoader(val_ds, min(batch_size, len(val_ds)), MelAudioBatchCollate(),
                                shuffle=False, num_workers=1)
        datasets.append(val_ds)

    exp = ExpManager(name="hifigan", explicit_log_dir=args.log_dir,
                     resume_if_exists=args.resume_if_exists)
    gen, mpd, msd = (m.to(device) for m in build_models(h))
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("generator", gen), ("mpd", mpd), ("msd", msd))}
    launch.say("parameters: " + ", ".join(f"{k} {v / 1e6:.2f}m" for k, v in n_params.items()))
    trainer = HiFiGANTrainer(
        gen, mpd, msd, args.log_dir, mel_cfg=mel_cfg,
        learning_rate=float(h.get("learning_rate", 2e-4)),
        adam_b1=float(h.get("adam_b1", 0.8)), adam_b2=float(h.get("adam_b2", 0.99)),
        lr_decay=float(h.get("lr_decay", 0.999)), steps_per_epoch=len(loader),
        bf16=args.bf16, exp=exp, datasets=datasets)
    first_epoch = 0
    if args.resume_if_exists and trainer.resume_if_exists():
        first_epoch = trainer.epoch + 1
        launch.say(f"resumed at iteration {trainer.iteration}, epoch {first_epoch}")
    loader.set_epoch(first_epoch)  # the shuffle of a straight run's epoch

    epochs = []
    for epoch in range(first_epoch, args.training_epochs):
        agg = trainer.train_epoch(loader, epoch)
        launch.say(f"epoch {epoch}: gen={agg['loss_gen']:.3f} disc={agg['loss_disc']:.3f} "
              f"mel={agg['mel_error']:.4f}")
        if val_loader is not None and epoch % args.validation_interval == 0:
            agg["val_mel_error"] = trainer.validate(val_loader, log_audio=2)
            launch.say(f"epoch {epoch}: validation mel error = {agg['val_mel_error']:.4f}")
        trainer.end_epoch(epoch)
        epochs.append(agg)
    trainer.save()
    trainer.ckpt.wait()  # drain the last checkpoint write
    path = trainer.save_generator()
    launch.say(f"saved generator: {path}")
    exp.close()
    return {"n_params": n_params, "iteration": trainer.iteration, "first_epoch": first_epoch,
            "epochs": epochs, "generator": path, "log_dir": trainer.log_dir}


if __name__ == "__main__":
    main()
