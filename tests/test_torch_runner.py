"""PyTorch port, serving entry points: the run_spiral CLI's test mode and the
runner against the JAX package's inference function on the same weights,
weight files (.npz JAX trees, .pt state_dicts), long-audio transcription,
and the port's freedom from JAX at import time."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.data.wav import read_wav, write_wav
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.text.tokenizers import CharTokenizer
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.compat.jax_spiral import ctc_finetune_from_jax
from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char
from tpu_speech_torch.ops import _build
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner
from tests.test_torch_spiral_ctc import jax_ctc_model, jax_encoder_cfg

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SR = 16000


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = spiral_tiny_ctc_char()
    jmodel = jax_ctc_model(cfg)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 112, 16)),
        jnp.full((1,), 112), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    jcfg = jax_encoder_cfg(cfg.model.encoder)

    @jax.jit
    def infer(wavs, lens):  # the JAX runner's _infer_fn (spiral_runner.py:1098)
        specs, spec_lens = jst2vec.wav_to_spec(jcfg, wavs, lens)
        return jmodel.apply({"params": params}, specs, spec_lens, train=False)

    return params, infer


def _corpus(root, n=5):
    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        dur = 0.35 + 0.15 * i
        wav = (rng.standard_normal(int(SR * dur)) * 0.1).astype(np.float32)
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, wav, SR)
        entries.append({"audio_filepath": path, "duration": dur,
                        "text": "hello world" if i % 2 else "speech test"})
    manifest = os.path.join(root, "test.json")
    with open(manifest, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    return manifest, entries


def _flat(tree, pre):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: np.asarray(tree)}


def _padded(entries):
    wavs = np.zeros((len(entries), SR), np.float32)
    lens = np.zeros((len(entries),), np.int32)
    for i, e in enumerate(entries):
        w, _ = read_wav(e["audio_filepath"])
        wavs[i, :len(w)] = w
        lens[i] = len(w)
    return wavs, lens


def test_cli_test_mode_matches_jax(tmp_path, jax_tiny, capsys):
    """run_spiral --run_mode test with JAX weights from an .npz: the saved
    log-probs of every batch equal the JAX inference on the same batch."""
    params, infer = jax_tiny
    manifest, entries = _corpus(str(tmp_path))
    np.savez(tmp_path / "weights.npz", **_flat(params, "params"))
    before = dict(_build.LAUNCHES)
    run_dir = str(tmp_path / "run")
    results = run_spiral.main([
        "--config_name", "spiral_tiny_ctc_char", "--model_type", "ctc_finetune",
        "--run_mode", "test", "--test_manifest", manifest, "--model_save_dir", run_dir,
        "--init_chkpt_dir", str(tmp_path), "--init_chkpt_file", "weights.npz",
        "--save_logits", "true", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "TEST: WER =" in out and results["n"] == len(entries)
    assert os.path.exists(os.path.join(run_dir, "wer_diagnosis.html"))
    assert _build.LAUNCHES == before  # plain versions on the CPU
    wavs, lens = _padded(entries)
    ref, _ = infer(jnp.asarray(wavs), jnp.asarray(lens))
    # test_ds.batch_size = 2: batches of 2, 2, 1
    got = np.concatenate([np.load(os.path.join(run_dir, "logits", f"logits_{n}.npy"))
                          for n in (2, 4, 5)])
    np.testing.assert_allclose(got, np.asarray(ref), atol=5e-4)


def test_pt_and_npz_weights_load_the_same_model(tmp_path, jax_tiny):
    params, _ = jax_tiny
    np.savez(tmp_path / "w.npz", **_flat(params, "params"))
    torch.save(ctc_finetune_from_jax(params, {}), tmp_path / "w.pt")
    loaded = []
    for f in ("w.npz", "w.pt"):  # the CLI's --init_chkpt_file path
        runner = SpiralFinetuneRunner(spiral_tiny_ctc_char(), str(tmp_path / f"run_{f}"),
                                      CharTokenizer(), device="cpu")
        runner.restore_from_checkpoint(str(tmp_path / f))
        loaded.append(runner.model.state_dict())
    a, b = loaded
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    for k, v in ctc_finetune_from_jax(params, {}).items():
        torch.testing.assert_close(a[k], v, rtol=0, atol=0)


def test_state_dict_file_unwraps_lightning_and_drops_reference_buffers(tmp_path, jax_tiny):
    params, _ = jax_tiny
    sd = ctc_finetune_from_jax(params, {})
    wrapped = {"state_dict": {**sd, "encoder.mask_emb": torch.zeros(16)}}
    torch.save(wrapped, tmp_path / "ref.ckpt")
    runner = SpiralFinetuneRunner(spiral_tiny_ctc_char(), str(tmp_path / "run"),
                                  CharTokenizer(), device="cpu")
    runner.restore_from_checkpoint(str(tmp_path / "ref.ckpt"))
    for k, v in ctc_finetune_from_jax(params, {}).items():
        torch.testing.assert_close(runner.model.state_dict()[k], v, rtol=0, atol=0)
    del sd["decoder.decoder_layers.0.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        runner.load_state_dict(sd)


def test_transcribe_short_and_long_audio(tmp_path, jax_tiny):
    """Short files decode as one padded batch; a file longer than
    max_duration (1 s here) decodes through overlapping windows."""
    params, _ = jax_tiny
    manifest, entries = _corpus(str(tmp_path), n=3)
    runner = SpiralFinetuneRunner(spiral_tiny_ctc_char(), str(tmp_path / "run"),
                                  CharTokenizer(), device="cpu")
    runner.load_state_dict(ctc_finetune_from_jax(params, {}))
    texts = runner.transcribe([e["audio_filepath"] for e in entries], batch_size=2)
    assert texts == runner.evaluate(manifest)["hyps"]
    rng = np.random.default_rng(1)
    long_path = str(tmp_path / "long.wav")
    write_wav(long_path, (rng.standard_normal(int(2.6 * SR)) * 0.1).astype(np.float32), SR)
    lp = runner._chunked_log_probs(read_wav(long_path)[0], overlap_s=0.4)
    # 4x-upsampled frames at 1/8 of the 100 Hz spec rate: ~50 per second
    assert abs(lp.shape[0] - 2.6 * 50) <= 8
    assert isinstance(runner.transcribe([long_path], overlap_s=0.4)[0], str)


def test_get_ckpt_path_glob(tmp_path):
    (tmp_path / "model-step1.pt").write_bytes(b"")
    assert run_spiral.get_ckpt_path(str(tmp_path), "model-*.pt").endswith("model-step1.pt")
    (tmp_path / "model-step2.pt").write_bytes(b"")
    with pytest.raises(ValueError):
        run_spiral.get_ckpt_path(str(tmp_path), "model-*.pt")


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or flax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_speech_torch, tpu_speech_torch.train.spiral_runner, "
        "tpu_speech_torch.cli.run_spiral\n"
        "for m in pkgutil.walk_packages(tpu_speech_torch.__path__, 'tpu_speech_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
