"""Speaker-encoder dataset preprocessing: the port's counterpart of
``cli/preprocess_spk.py`` (the reference DiffVC/speaker_encoder/encoder/
preprocess.py).

    python -m tpu_speech_torch.cli.preprocess_spk RAW -o OUT [-n NAME] [-s]

Walks a root of per-speaker audio directories (``.wav``, and ``.flac``
through whichever decoder the host has), preprocesses each utterance
(resample to 16 kHz, volume normalisation, the energy VAD trim), computes
40-mel power frames and writes per-speaker directories of ``.npy`` files for
``cli.train_spk_encoder``, with the reference's ``Log_<name>.txt`` statistics
and per-speaker ``_sources.txt`` provenance. Utterances shorter than one
160-frame partial are skipped. Host numpy only, as the JAX CLI: it takes no
``--device``.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np

from tpu_speech_torch.data.wav import read_audio
from tpu_speech_torch.models.speaker_encoder import (
    PARTIALS_N_FRAMES,
    SAMPLING_RATE,
    preprocess_wav,
    wav_to_mel_spectrogram,
)

AUDIO_EXTS = (".wav", ".flac")


def preprocess_speaker_dirs(datasets_root: str, out_dir: str, dataset_name: str = "dataset",
                            skip_existing: bool = False) -> int:
    """Returns the number of utterances written."""
    os.makedirs(out_dir, exist_ok=True)
    speaker_dirs = sorted(d for d in os.listdir(datasets_root)
                          if os.path.isdir(os.path.join(datasets_root, d)))
    log_path = os.path.join(out_dir, f"Log_{dataset_name}.txt")
    durations = []
    n_utts = 0
    with open(log_path, "w") as log:
        log.write(f"Creating dataset {dataset_name} on {datetime.now()}\n-----\n")
        for spk in speaker_dirs:
            spk_in = os.path.join(datasets_root, spk)
            spk_out = os.path.join(out_dir, spk)
            os.makedirs(spk_out, exist_ok=True)
            with open(os.path.join(spk_out, "_sources.txt"),
                      "a" if skip_existing else "w") as sources:
                for root, _, files in os.walk(spk_in):
                    for fname in sorted(files):
                        if not fname.lower().endswith(AUDIO_EXTS):
                            continue
                        in_fpath = os.path.join(root, fname)
                        rel = os.path.relpath(in_fpath, spk_in)
                        out_fname = os.path.splitext(rel.replace(os.sep, "_"))[0] + ".npy"
                        out_fpath = os.path.join(spk_out, out_fname)
                        if skip_existing and os.path.exists(out_fpath):
                            continue
                        wav, sr = read_audio(in_fpath)
                        wav = preprocess_wav(wav, sr)
                        if len(wav) == 0:
                            continue
                        frames = wav_to_mel_spectrogram(wav)
                        if len(frames) < PARTIALS_N_FRAMES:
                            continue  # too short for one partial utterance
                        np.save(out_fpath, frames)
                        sources.write(f"{out_fname},{in_fpath}\n")
                        durations.append(len(wav) / SAMPLING_RATE)
                        n_utts += 1
        log.write("Statistics:\n")
        if durations:
            log.write(f"\tduration: min {np.min(durations):.3f}, "
                      f"max {np.max(durations):.3f}, mean {np.mean(durations):.3f}\n")
        log.write(f"\tutterances: {n_utts}\n")
        log.write(f"Finished on {datetime.now()}\n")
    print(f"Done preprocessing {dataset_name}: "
          f"{n_utts} utterances from {len(speaker_dirs)} speakers.")
    return n_utts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets_root", help="directory of per-speaker audio directories")
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("-n", "--dataset_name", default="dataset")
    ap.add_argument("-s", "--skip_existing", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return preprocess_speaker_dirs(args.datasets_root, args.out_dir, args.dataset_name,
                                   args.skip_existing)


if __name__ == "__main__":
    main()
