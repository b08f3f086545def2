"""GE2E speaker-encoder training: the port's counterpart of
``cli/train_spk_encoder.py`` (the reference DiffVC/speaker_encoder/encoder/
train.py behind the RTVC ``encoder_train`` surface).

    python -m tpu_speech_torch.cli.train_spk_encoder RUN_ID CLEAN_ROOT \\
        [-m saved_models] [-u 100] [-s 500] [-b 7500] [-v 10] [-f] \\
        [--speakers_per_batch 64] [--utterances_per_speaker 10] \\
        [--n_frames 160] [--max_steps N] [--lr 1e-4] [--device cuda]

Per-speaker directories of ``.npy`` mel frames (``cli.preprocess_spk``) ->
``train/speaker_encoder.py::train_speaker_encoder``: the GE2E loss with the
loss and EER every ``-v`` steps, PCA projections every ``-u`` steps (0 off;
matplotlib), checkpoints every ``-s`` steps with resume (``-f`` starts
over), backups every ``-b``, and ``<models_dir>/<run_id>.pt`` (``{'model_state',
'step'}``), which ``cli.inference_vc --spk-encoder`` loads. ``--device``
defaults to ``cuda`` and raises without a card; on the card the LSTM runs
with TF32 off (``utils/device.py::use_full_fp32``).
"""

from __future__ import annotations

import argparse

from tpu_speech_torch.train.speaker_encoder import train_speaker_encoder
from tpu_speech_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_id", help="name for this training run")
    ap.add_argument("clean_data_root",
                    help="directory of preprocessed per-speaker directories of .npy mel frames")
    ap.add_argument("-m", "--models_dir", default="saved_models")
    ap.add_argument("-u", "--umap_every", type=int, default=100,
                    help="steps between embedding-projection images (0 off)")
    ap.add_argument("-s", "--save_every", type=int, default=500)
    ap.add_argument("-b", "--backup_every", type=int, default=7500)
    ap.add_argument("-v", "--vis_every", type=int, default=10)
    ap.add_argument("-f", "--force_restart", action="store_true",
                    help="do not resume from an existing checkpoint")
    ap.add_argument("--speakers_per_batch", type=int, default=64)
    ap.add_argument("--utterances_per_speaker", type=int, default=10)
    ap.add_argument("--n_frames", type=int, default=160)
    ap.add_argument("--max_steps", type=int, default=1_000_000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' runs on the CPU")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    return train_speaker_encoder(
        clean_data_root=args.clean_data_root, models_dir=args.models_dir, run_id=args.run_id,
        speakers_per_batch=args.speakers_per_batch,
        utterances_per_speaker=args.utterances_per_speaker, n_frames=args.n_frames,
        learning_rate=args.lr, max_steps=args.max_steps, vis_every=args.vis_every,
        umap_every=args.umap_every, save_every=args.save_every,
        backup_every=args.backup_every, force_restart=args.force_restart, device=device)


if __name__ == "__main__":
    main()
