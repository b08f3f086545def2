"""PyTorch port, ``cli/get_librispeech_data.py``'s offline mode against the
JAX CLI: on a synthetic LibriSpeech tree (two splits, speakers and chapters
with ``*.trans.txt``, wavs made beforehand, one utterance with an
undecodable flac and no wav) the JAX CLI, run as a subprocess, and the
port's ``main`` write equal manifests line for line, and both skip the
utterance they cannot decode. ``--download`` stops before any network
access and names its ROADMAP item.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile

from tpu_speech_torch.cli import get_librispeech_data as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("dev-clean", "train-clean-100")


def write_tree(root, seed=0):
    """LibriSpeech/<split>/<speaker>/<chapter>/<spk>-<chap>.trans.txt with
    mixed-case transcripts, each utterance's wav already in wavs/<split>/,
    and one utterance whose flac is not audio."""
    r = np.random.default_rng(seed)
    for s, split in enumerate(SPLITS):
        wav_dir = os.path.join(root, "wavs", split)
        os.makedirs(wav_dir, exist_ok=True)
        for spk in (19 + s, 103):
            for chap in (198, 1240):
                d = os.path.join(root, "LibriSpeech", split, str(spk), str(chap))
                os.makedirs(d)
                lines = []
                for u in range(3):
                    utt = f"{spk}-{chap}-{u:04d}"
                    lines.append(f"{utt} THE Cat {chr(65 + u)} sat ON the Mat")
                    if (spk, chap, u) == (103, 1240, 1):
                        with open(os.path.join(d, utt + ".flac"), "wb") as f:
                            f.write(b"not a flac stream")
                        continue
                    pcm = (r.standard_normal(int(r.integers(1600, 8000))) * 3000).astype(np.int16)
                    scipy.io.wavfile.write(os.path.join(wav_dir, utt + ".wav"), 16000, pcm)
                with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as f:
                    f.write("\n".join(lines) + "\n")


def _manifest(root, split, relative_to):
    with open(os.path.join(root, f"librivox-{split}.json")) as f:
        return f.read().replace(relative_to, "<root>")


def test_manifests_equal_the_jax_cli(tmp_path):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    write_tree(jax_root)
    shutil.copytree(jax_root, port_root)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "cli", "get_librispeech_data.py"), "--data_root",
         jax_root, "--data_sets", ",".join(SPLITS), "--manifest_dir", jax_root + "/m"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = port_cli.main(["--data_root", port_root, "--data_sets", " , ".join(SPLITS),
                            "--manifest_dir", port_root + "/m"])
    assert counts == {"dev-clean": 11, "train-clean-100": 11}
    for split in SPLITS:
        want = _manifest(jax_root + "/m", split, os.path.abspath(jax_root))
        got = _manifest(port_root + "/m", split, os.path.abspath(port_root))
        assert got == want
        lines = got.splitlines()
        assert len(lines) == 11 and "103-1240-0001" not in got
        assert '"text": "the cat a sat on the mat"' in lines[0]


def test_default_manifest_dir_and_one_split(tmp_path):
    root = str(tmp_path)
    write_tree(root, seed=1)
    assert port_cli.main(["--data_root", root]) == {"dev-clean": 11}
    assert os.path.exists(os.path.join(root, "manifest_json", "librivox-dev-clean.json"))


def test_download_stops_and_names_the_item(tmp_path):
    with pytest.raises(SystemExit, match="Queue 1 item 9"):
        port_cli.main(["--data_root", str(tmp_path), "--download"])
    assert not os.listdir(tmp_path)
