"""PyTorch port, the subword transcription slice: ``run_spiral --run_mode test``
with a subword vocab, prefix beam search and an n-gram LM, on the port's CLI
and the JAX CLI with one archive's weights, at SPIRAL-large's block structure
narrowed; the refusals that stay (items 9 and 10); the featurizer's other
normalizations and magnitude powers, K1's ``pow`` plain version, and K2's
plain version at the toy config's head width 12, each against the JAX
package.
"""

import contextlib
import io
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral.features import filterbank_features as jax_features
from tpu_speech.ops.fused_attention import fused_qkv_self_attention as jax_fused_qkv
from tpu_speech.utils import archive as jarchive
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models.spiral.features import filterbank_features
from tpu_speech_torch.ops.fused_attention import qkv_attention_plain
from tpu_speech_torch.ops.fused_logmel import logmel_plain
from tpu_speech_torch.text.tokenizers import SubwordTokenizer
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner
from tpu_speech_torch.utils import archive

from tests.test_torch_ctc_beam import _write_vocab
from tests.test_torch_spiral_large import narrow_large_encoder

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SR = 16000
LOGP_ATOL = 5e-4  # the whole slice against JAX (PERF.md section 2)
K1_ATOL = 1e-4
NAME = "spiral_narrow_large_subword"
WORDS = ("the", "cat", "sat", "he", "is", "reading", "a", "red", "hat", "there")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_large_subword():
    """``spiral_large_finetune_ls100_subword`` with SPIRAL-large's block
    structure at narrow widths (2 and 3 layers, 16 mels), a 32-wide subword
    head, test batches of 2 padded to 1 s."""
    cfg = CONFIGS["spiral_large_finetune_ls100_subword"]()
    cfg.model.encoder = narrow_large_encoder(layers=(2, 3))
    dec = cfg.model.decoder
    cfg.model.decoder = type(dec)(**{**dec.__dict__, "conv_layers": tuple(
        type(c)(**{**c.__dict__, "filters": 32}) for c in dec.conv_layers)})
    cfg.model.train_ds.max_duration = 1.0
    cfg.model.test_ds.batch_size = 2
    cfg.model.test_ds.num_workers = 1
    return cfg


def _corpus(root, n=5, seed=0):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        dur = 0.4 + 0.12 * i
        t = np.arange(int(SR * dur)) / SR
        wav = (0.1 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, wav, SR)
        text = " ".join(rng.choice(WORDS, size=rng.integers(2, 5)))
        entries.append({"audio_filepath": path, "duration": dur, "text": text})
    manifest = os.path.join(root, "test.json")
    with open(manifest, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    return manifest, entries


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """One archive of the narrow model's seeded init, served by both CLIs
    with ``--tokenizer_file``, ``--beam_size 4`` and an order-3 LM."""
    root = tmp_path_factory.mktemp("slice")
    vocab = _write_vocab(root / "vocab.tsv", scored=True)
    manifest, entries = _corpus(str(root))
    for name in ("librivox-train-clean-100.json", "librivox-dev-other.json"):
        shutil.copy(manifest, root / name)  # the JAX runner reads its training manifest
    cfg = narrow_large_subword()
    runner = SpiralFinetuneRunner(cfg, str(root / "init"), SubwordTokenizer(vocab),
                                  device="cpu")
    path = runner.save_archive()
    mp = pytest.MonkeyPatch()
    mp.setitem(run_spiral.CONFIGS, NAME, narrow_large_subword)
    # the JAX CLI imports <config_path>/<name> as a module with a cfg
    jcfg = jarchive.config_object(json.loads(json.dumps(archive._to_jsonable(cfg))))
    mod = types.ModuleType(f"narrowconf.{NAME}")
    mod.cfg = jcfg
    mp.setitem(sys.modules, "narrowconf", types.ModuleType("narrowconf"))
    mp.setitem(sys.modules, f"narrowconf.{NAME}", mod)
    sys.path.insert(0, os.path.join(REPO, "cli"))
    import run_spiral as jax_cli  # noqa: E402

    sys.path.pop(0)
    out = {}
    try:
        for beam, lm in ((4, True), (4, False), (1, False)):
            args = ["--model_type", "ctc_finetune", "--run_mode", "test", "--config_name", NAME,
                    "--tokenizer_file", vocab, "--test_manifest", manifest,
                    "--init_archive", path, "--save_logits", "true", "--manifest_dir", str(root),
                    "--beam_size", str(beam), "--lm_order", "3", "--lm_alpha", "0.7"]
            if lm:
                args += ["--lm_manifest", manifest]
            tag = f"beam{beam}{'_lm' if lm else ''}"
            port_dir, jax_dir = root / f"port_{tag}", root / f"jax_{tag}"
            lines, res = [], None
            for run in (lambda: run_spiral.main(args + ["--model_save_dir", str(port_dir),
                                                        "--device", "cpu"]),
                        lambda: jax_cli.main(args + ["--model_save_dir", str(jax_dir),
                                                     "--config_path", "narrowconf"])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    res = run() or res  # the JAX CLI returns None
                lines.append([ln for ln in buf.getvalue().splitlines()
                              if ln.startswith(("TEST:", "n-gram LM"))])
            out[tag] = (res, port_dir, jax_dir, lines)
    finally:
        mp.undo()
    return out, entries


def _logits(run_dir):
    return np.concatenate([np.load(os.path.join(run_dir, "logits", f"logits_{n}.npy"))
                           for n in (2, 4, 5)])


def _html(run_dir):
    with open(os.path.join(run_dir, "wer_diagnosis.html"), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("tag", ["beam4_lm", "beam4", "beam1"])
def test_subword_slice_equals_jax_cli(slice_run, tag):
    """The same log-probs within 5e-4, the same transcripts (the two
    packages' per-utterance diagnoses are equal text), the same printed WER
    and CER line (and LM line)."""
    out, entries = slice_run
    res, port_dir, jax_dir, (port_lines, jax_lines) = out[tag]
    got, want = _logits(port_dir), _logits(jax_dir)
    assert got.shape == want.shape and got.shape[-1] == 33  # 32 pieces + the blank
    np.testing.assert_allclose(got, want, atol=LOGP_ATOL, rtol=0)
    assert _html(port_dir) == _html(jax_dir)
    assert port_lines == jax_lines and len(port_lines) == (2 if tag.endswith("lm") else 1)
    assert res["n"] == len(entries) and len(res["hyps"]) == len(entries)
    assert port_lines[-1].startswith(f"TEST: WER = {res['wer']:.4f} | CER = {res['cer']:.4f}")


def test_the_lm_and_the_beam_move_the_transcripts(slice_run):
    """The slice is not vacuous: the LM's fusion changes what the beam picks
    on the same log-probs."""
    out, _ = slice_run
    assert out["beam4"][0]["hyps"] != out["beam4_lm"][0]["hyps"]
    assert any(out["beam1"][0]["hyps"])


def test_items_9_and_10_still_refuse(tmp_path, monkeypatch):
    """No flag of items 10 and 11 refuses any more: ``--seq_parallel`` in
    test mode stops at the finetune runner, which raises as JAX's does
    (the seq axis is pretraining's); ``--num_nodes 2`` with no rendezvous fails with
    ``require_multiprocess``'s message; ``--fsdp true`` in test mode reaches
    the evaluation with ``trainer.fsdp`` set (serving builds no optimizer, so
    nothing is sharded). Item 9's streaming flag and configs are ported:
    ``--streaming_eval`` on an offline config stops at the model, which has
    no streaming mode."""
    argv = ["--model_type", "ctc_finetune", "--run_mode", "test", "--config_name",
            "spiral_tiny_ctc_char", "--device", "cpu", "--model_save_dir",
            str(tmp_path / "run")]
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="pretrain-only knob"):
        run_spiral.main(argv + ["--seq_parallel", "2"])
    with pytest.raises(RuntimeError, match=r"--num_nodes=2 but only 1 process\(es\) federated"):
        run_spiral.main(argv + ["--num_nodes", "2"])
    assert not os.path.exists(tmp_path / "run")
    seen = []

    def evaluate(self, **kw):
        seen.append(self.cfg.trainer.fsdp)
        return {"wer": 0.0, "cer": 0.0, "n": 0, "diagnosis_html": "", "rank": 0, "hyps": []}

    monkeypatch.setattr(run_spiral.SpiralFinetuneRunner, "evaluate", evaluate)
    run_spiral.main(argv + ["--fsdp", "true"])
    assert seen == [True]
    with pytest.raises(ValueError, match="streaming-mode model"):
        run_spiral.main(argv + ["--streaming_eval", "true"])
    assert not hasattr(run_spiral, "NOT_PORTED")  # every flag of the JAX CLI runs


def test_subword_config_without_a_tokenizer_file_stops(tmp_path):
    with pytest.raises(SystemExit, match="--tokenizer_file"):
        run_spiral.main(["--model_type", "ctc_finetune", "--run_mode", "test",
                         "--config_name", "spiral_base_finetune_ls100_subword",
                         "--device", "cpu", "--model_save_dir", str(tmp_path / "run")])


def test_transcribe_with_beam_and_lm_equals_evaluate(slice_run, tmp_path):
    """``transcribe`` takes the same beam and LM as ``evaluate``."""
    from tpu_speech_torch.eval.ctc_beam import NGramLM

    _, entries = slice_run
    vocab = _write_vocab(tmp_path / "vocab.tsv", scored=True)
    runner = SpiralFinetuneRunner(narrow_large_subword(), str(tmp_path / "r"),
                                  SubwordTokenizer(vocab), device="cpu")
    lm = NGramLM.from_texts([e["text"] for e in entries], runner.tokenizer, order=3)
    paths = [e["audio_filepath"] for e in entries]
    texts = runner.transcribe(paths, batch_size=2, beam_width=4, lm=lm, lm_alpha=0.7)
    manifest = os.path.join(os.path.dirname(paths[0]), "test.json")
    res = runner.evaluate(manifest, beam_width=4, lm=lm, lm_alpha=0.7)
    assert texts == res["hyps"]
    assert res["decode_s"] > 0


# ---- the featurizer's branches, K1's pow and K2 at d_head 12 ------------------

def _wavs(seed, b=3, n=9000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.1 * np.sin(2 * np.pi * rng.uniform(80, 400, (b, 1)) * t) + \
        0.02 * rng.standard_normal((b, n))
    lens = np.array([n, n - 2000, n // 3][:b], np.int32)
    return x.astype(np.float32), lens


@pytest.mark.parametrize("normalize,mag_power", [
    ("all_features", 2.0), ("per_feature", 1.5), ("all_features", 3.0), ("none", 0.5),
    ("per_feature", 2.0), ("none", 1.0),
])
def test_featurizer_branches_match_jax(normalize, mag_power):
    x, lens = _wavs(int(mag_power * 10) + len(normalize))
    kw = dict(sample_rate=SR, nfilt=40, mag_power=mag_power, normalize=normalize)
    want, wl = jax_features(jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=False, **kw)
    got, gl = filterbank_features(torch.tensor(x), torch.tensor(lens), **kw)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K1_ATOL, rtol=0)


def _causal_float64(raw, lens, hop=160):
    """per_feature_causal on JAX's un-normalized log-mel, in float64."""
    raw = np.asarray(raw, np.float64)
    valid = np.arange(raw.shape[1])[None, :] < np.ceil(lens / hop)[:, None]
    vm = valid.astype(np.float64)[..., None]
    cnt, s1, s2 = (np.cumsum(a, axis=1) for a in (vm, raw * vm, raw ** 2 * vm))
    mean = s1 / np.maximum(cnt, 1.0)
    var = (s2 - cnt * mean ** 2) / np.maximum(cnt - 1.0, 1.0)
    return (raw - mean) / (np.sqrt(np.maximum(var, 0.0)) + 1e-5) * vm


@pytest.mark.parametrize("mag_power", [2.0, 1.0, 1.5])
def test_causal_normalization_matches_jax_within_its_float32_error(mag_power):
    """per_feature_causal's variance s2 - n mean^2 cancels over the first
    frames: JAX's float32 sums land up to ~5e-2 off the float64 value there,
    by an amount that depends on the summation order. The port sums in
    float64: within 1e-4 of the float64 normalization of JAX's own log-mel,
    and nowhere farther from JAX than JAX is from that value (ROADMAP Queue
    3)."""
    x, lens = _wavs(int(mag_power * 10) + 18)
    kw = dict(sample_rate=SR, nfilt=40, mag_power=mag_power)
    raw, _ = jax_features(jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=False,
                          normalize="none", **kw)
    ref = _causal_float64(raw, lens)
    want, _ = jax_features(jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=False,
                           normalize="per_feature_causal", **kw)
    got, _ = filterbank_features(torch.tensor(x), torch.tensor(lens),
                                 normalize="per_feature_causal", **kw)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, ref, atol=K1_ATOL, rtol=0)
    assert np.all(np.abs(got - want) <= np.abs(want - ref) + K1_ATOL)


@pytest.mark.parametrize("mag_power", [0.5, 1.5, 3.0])
def test_k1_pow_plain_matches_the_jax_rfft_path(mag_power):
    """K1's ``pow`` plain version against the JAX featurizer's rfft pipeline
    (framing, window, rfft, |X|^p, mel, log) on the same padded signal."""
    from tpu_speech.audio.mel import frame_signal, mel_filterbank

    rng = np.random.default_rng(3)
    n_fft, hop = 512, 160
    xp = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    win = np.hanning(n_fft).astype(np.float32)
    fb = mel_filterbank(SR, n_fft, 64, 0.0, SR / 2).astype(np.float32)
    frames = 1 + (xp.shape[1] - n_fft) // hop
    spec = jnp.fft.rfft(frame_signal(jnp.asarray(xp), n_fft, hop) * jnp.asarray(win), axis=-1)
    mag = jnp.sqrt(jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) ** mag_power
    want = jnp.log(mag @ jnp.asarray(fb).T + 2.0 ** -24)
    got = logmel_plain(torch.tensor(xp), torch.tensor(win), torch.tensor(fb), n_fft=n_fft,
                       hop_length=hop, num_frames=frames, mag_mode="pow",
                       mag_power=mag_power)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K1_ATOL, rtol=0)


def test_k2_plain_at_d_head_12_matches_jax():
    """The toy config's attention (E 48, 4 heads: d_head 12), with padded
    keys, against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(12)
    b, t, e, h = 3, 37, 48, 4
    qkv = rng.standard_normal((b, t, 3 * e)).astype(np.float32)
    qkv[..., :e] *= 12 ** -0.5
    mask = np.arange(t)[None, :] >= np.array([37, 20, 9])[:, None]
    want = jax_fused_qkv(jnp.asarray(qkv), h, jnp.asarray(mask), interpret=True)
    got = qkv_attention_plain(torch.tensor(qkv), h, torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
