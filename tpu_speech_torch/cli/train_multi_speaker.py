"""Grad-TTS multi-speaker training CLI: the port's counterpart of
``cli/train_multi_speaker.py`` (the reference train_multi_speaker.py recipe:
a Libri-TTS filelist with '|'-separated speaker ids, n_spks = 247).

    python -m tpu_speech_torch.cli.train_multi_speaker [--device cpu]

Set ``n_spks`` in ``tpu_speech_torch/configs/gradtts.py`` first. Several
cards run as ``cli/train.py`` does: one rank per visible card.
"""

from __future__ import annotations

from tpu_speech_torch.cli import train
from tpu_speech_torch.configs import gradtts as cfg


def main(argv=None, _init_method=None) -> dict:
    if cfg.n_spks <= 1:
        raise SystemExit("set n_spks in configs/gradtts.py (e.g. 247 for Libri-TTS)")
    return train.main(argv, multispeaker=True, _init_method=_init_method)


if __name__ == "__main__":
    main()
