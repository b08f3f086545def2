"""LibriSpeech data preparation, offline: an extracted LibriSpeech tree ->
16-bit wavs and JSON manifests. The port's counterpart of
``cli/get_librispeech_data.py`` (the reference SPIRAL/scripts/
get_librispeech_data.py).

    python -m tpu_speech_torch.cli.get_librispeech_data --data_root D
        [--data_sets dev-clean,train-clean-100] [--manifest_dir M]

For each split, every ``D/LibriSpeech/<split>/<speaker>/<chapter>/
*.trans.txt`` line becomes ``D/wavs/<split>/<utt>.wav`` (a wav already
there is kept; a flac is decoded by ``data/wav.py::decode_to_wav``, and an
utterance with no decoder is skipped) and a line of
``M/librivox-<split>.json`` (``audio_filepath``, ``duration``, lowercased
``text``), line for line as the JAX CLI writes them. ``M`` defaults to
``D/manifest_json``. Host only: it takes no ``--device``.

``--download`` is not ported (ROADMAP Queue 1 item 9): it stops before any
network access.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from tpu_speech_torch.data.wav import decode_to_wav


def flac_to_wav(flac_path: str, wav_path: str) -> bool:
    """Decode FLAC to a 16-bit wav with the host's decoder; False if none."""
    return decode_to_wav(flac_path, wav_path)


def build_manifest(split_dir: str, wav_dir: str, manifest_path: str) -> int:
    """Wavs under ``wav_dir`` and the manifest of one split; returns the
    number of utterances written."""
    import scipy.io.wavfile

    entries = []
    for trans in sorted(glob.glob(os.path.join(split_dir, "*", "*", "*.trans.txt"))):
        with open(trans) as f:
            for line in f:
                utt_id, text = line.strip().split(" ", 1)
                flac = os.path.join(os.path.dirname(trans), utt_id + ".flac")
                wav = os.path.join(wav_dir, utt_id + ".wav")
                if not os.path.exists(wav) and not flac_to_wav(flac, wav):
                    continue
                sr, data = scipy.io.wavfile.read(wav)
                entries.append({"audio_filepath": os.path.abspath(wav),
                                "duration": len(data) / sr, "text": text.lower()})
    with open(manifest_path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    print(f"{manifest_path}: {len(entries)} utterances")
    return len(entries)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--data_sets", default="dev-clean")
    ap.add_argument("--manifest_dir", default=None)
    ap.add_argument("--download", action="store_true",
                    help="not ported (ROADMAP Queue 1 item 9): stops the run")
    return ap


def main(argv=None) -> dict:
    """Returns {split: utterances written}."""
    args = build_parser().parse_args(argv)
    if args.download:
        raise SystemExit("--download is not ported: ROADMAP.md Queue 1 item 9 (the port "
                         "builds wavs and manifests from an extracted LibriSpeech tree under "
                         "--data_root only)")
    manifest_dir = args.manifest_dir or os.path.join(args.data_root, "manifest_json")
    os.makedirs(manifest_dir, exist_ok=True)
    counts = {}
    for split in args.data_sets.split(","):
        split = split.strip()
        wav_dir = os.path.join(args.data_root, "wavs", split)
        os.makedirs(wav_dir, exist_ok=True)
        counts[split] = build_manifest(
            os.path.join(args.data_root, "LibriSpeech", split), wav_dir,
            os.path.join(manifest_dir, f"librivox-{split}.json"))
    return counts


if __name__ == "__main__":
    main()
