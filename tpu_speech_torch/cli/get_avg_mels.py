"""DiffVC's average-voice targets: the port's counterpart of
``cli/get_avg_mels.py`` (the reference DiffVC/get_avg_mels.ipynb).

    python -m tpu_speech_torch.cli.get_avg_mels --data-dir D [--avg-type mode]

Per-phoneme corpus statistics over ``D/mels`` and ``D/textgrids`` (each
utterance's median mel over a phone's frames, then the corpus mode per mel
bin) painted over each utterance's phones -> ``D/mels_<avg-type>/<spk>/
<id>_avgmel.npy``, the targets of ``cli.train_enc``. Host numpy only, as the
JAX CLI: it takes no ``--device``.
"""

from __future__ import annotations

import argparse

from tpu_speech_torch.data.diffvc import build_average_mels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True,
                    help="dataset dir with mels/ and textgrids/ subdirs")
    ap.add_argument("--avg-type", default="mode")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    modes = build_average_mels(args.data_dir, avg_type=args.avg_type)
    print(f"Built mels_{args.avg_type} for {len(modes)} phonemes.")
    return modes


if __name__ == "__main__":
    main()
