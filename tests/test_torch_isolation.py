"""The port imports nothing of the JAX package and nothing of JAX.

In a fresh interpreter, a ``sys.meta_path`` finder raises on any import of
``tpu_speech`` (but not ``tpu_speech_torch``) or ``jax``/``jaxlib``; then
every module of ``tpu_speech_torch`` (walked with ``pkgutil``) and
``chip_smoke`` are imported, the archive reader rebuilds every SPIRAL config
from its JAX-namespace tags, and ``run_spiral --help``, the TTS CLI's
``inference --help``, the Grad-TTS training CLI's ``train --help``, the
voice-conversion CLI's ``inference_vc --help`` and the five DiffVC and
speaker-encoder training CLIs' ``--help`` run.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib
import importlib.abc
import pkgutil
import sys

BANNED = ("tpu_speech", "jax", "jaxlib")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
import tpu_speech_torch

names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(tpu_speech_torch.__path__, "tpu_speech_torch.")]
for name in names:
    importlib.import_module(name)
from tpu_speech_torch.cli import (get_avg_mels, inference, inference_vc, preprocess_spk,
                                  run_spiral, train, train_dec, train_enc, train_spk_encoder)

for cli in (run_spiral, inference, train, inference_vc, get_avg_mels, train_enc, train_dec,
            preprocess_spk, train_spk_encoder):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
# an archive's config names the JAX package's classes; the port's reader
# maps them to its own and imports no tpu_speech. module
from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.utils import archive

for make in CONFIGS.values():
    blob = archive._to_jsonable(make())
    assert blob["__dataclass__"] == "tpu_speech.utils.config.RunConfig", blob["__dataclass__"]
    assert type(archive.config_object(blob)).__module__ == "tpu_speech_torch.utils.config"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(" ".join(names))
print("IMPORTED", len(names))
"""


def test_port_imports_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    n = int(proc.stdout.split("IMPORTED")[-1])
    assert n > 30, proc.stdout  # every module of the port, not an empty walk
    assert "--model_type" in proc.stdout  # the CLIs' help texts ran
    assert "--hifigan-config" in proc.stdout
    assert "Grad-TTS training CLI" in proc.stdout
    assert "--spk-encoder" in proc.stdout
    for flag in ("--avg-type", "--exc-file", "--enc-ckpt", "--val-file", "--skip_existing",
                 "--speakers_per_batch", "--backup_every"):
        assert flag in proc.stdout, flag
    for name in ("train.diffvc", "train.speaker_encoder", "data.diffvc", "data.textgrid",
                 "data.speaker_verification", "cli.train_spk_encoder", "utils.surgery",
                 "utils.msgpack", "utils.archive"):
        assert f"tpu_speech_torch.{name}" in proc.stdout, name
