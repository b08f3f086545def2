"""DiffVC stage 1, the average-voice encoder: the port's counterpart of
``cli/train_enc.py`` (the reference DiffVC/train_enc.py recipe: the masked
MSE to phoneme-averaged mels, Adam 5e-4, batch 128, 300 epochs).

    python -m tpu_speech_torch.cli.train_enc --data-dir D [--exc-file F] \\
        [--avg-type mode] [--log-dir logs/enc] [--epochs 300] \\
        [--batch-size 128] [--lr 5e-4] [--device cuda]

``D/mels`` and ``D/mels_<avg-type>`` (``cli.get_avg_mels``) -> random
aligned crops of ``configs/diffvc.py``'s ``train_frames`` on loader threads
-> ``train/diffvc.py::enc_train_step`` on the device -> ``train.log``,
TensorBoard, a checkpoint each epoch in ``<log-dir>/ckpt`` and the previews'
Griffin-Lim wavs (and, where matplotlib is installed, mel images). A run on
a log dir that holds checkpoints resumes from the latest one, at the epoch
after it. At the end it writes ``<log-dir>/enc.pt``, the encoder's
reference-named state_dict (the reference's ``FwdDiffusion`` names), which
``cli.train_dec --enc-ckpt`` and the JAX package's ``cli/train_dec.py``
load. The model's initial weights are the reference's (each module's
PyTorch default) after ``torch.manual_seed(seed)``. ``--device`` defaults
to ``cuda`` and raises without a card. fp32 only: ``--precision bf16``
raises (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import importlib.util

import torch

from tpu_speech_torch.configs import diffvc as params
from tpu_speech_torch.data.diffvc import VCEncBatchCollate, VCEncDataset
from tpu_speech_torch.data.loader import DataLoader
from tpu_speech_torch.models.diffvc import FwdDiffusion
from tpu_speech_torch.train.diffvc import DiffVCTrainer, enc_train_step, make_enc_preview
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.exp_manager import ExpManager


def refuse_bf16(precision: str) -> None:
    if precision != "fp32":
        raise NotImplementedError(f"precision {precision!r}: DiffVC training runs in fp32; "
                                  "bf16 is not ported yet (ROADMAP.md, Queue 1)")


def images_available() -> bool:
    """The previews' mel images need matplotlib; without it only their
    wavs are written."""
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    print("matplotlib is missing: the previews write their wavs, no mel images")
    return False


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--exc-file", default=None)
    ap.add_argument("--avg-type", default="mode")
    ap.add_argument("--log-dir", default="logs/enc")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="fp32 only; bf16 raises (ROADMAP.md, Queue 1)")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' runs on the CPU")
    return ap


def build_encoder() -> FwdDiffusion:
    """FwdDiffusion at the config's width, the reference's initialisation
    drawn after ``torch.manual_seed(seed)``."""
    torch.manual_seed(params.seed)
    return FwdDiffusion(params.n_mels, params.channels, params.filters, params.heads,
                        params.layers, params.kernel, params.dropout, params.window_size,
                        params.enc_dim)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    refuse_bf16(args.precision)

    dataset = VCEncDataset(args.data_dir, args.exc_file, args.avg_type,
                           shuffle_seed=params.seed)
    collate = VCEncBatchCollate(params.train_frames, params.n_mels, params.seed)
    loader = DataLoader(dataset, args.batch_size, collate, shuffle=True, num_workers=4,
                        seed=params.seed)

    model = build_encoder().to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Number of encoder parameters = {n_params / 1e6:.2f}m")

    exp = ExpManager(name="diffvc_enc", explicit_log_dir=args.log_dir)
    exp.save_config(vars(args))
    # the preview's crops draw from a collate of their own, not the loader's
    preview_batch = VCEncBatchCollate(params.train_frames, params.n_mels, params.seed)(
        [dataset[i] for i in range(min(2, len(dataset)))])
    trainer = DiffVCTrainer(model, enc_train_step, args.log_dir, args.lr, seed=params.seed,
                            exp=exp, preview_fn=make_enc_preview(
                                preview_batch, sample_rate=params.sampling_rate,
                                images=images_available()))
    res = trainer.fit(loader, args.epochs)
    res["state_dict"] = trainer.save_state_dict("enc")
    res["n_params"] = n_params
    print(f"saved encoder: {res['state_dict']}")
    exp.close()
    return res


if __name__ == "__main__":
    main()
