"""PyTorch port, model export: ``utils/export.py`` (``torch.export`` programs
in ``.pt2`` files), ``cli/export_tts.py`` and ``run_spiral --export_model``,
and the kernels as the registered ops that those graphs keep
(``tpu_speech::fused_logmel``, ``::fused_qkv_attention_fwd``,
``::grouped_posconv``).

The TTS graph draws its noise from the seed input (``ops/random.py``), which
is not JAX's stream: the reloaded program is held to the eager serving
function (1e-5, ``tests/test_export_tts.py:89``'s bound), and the parity with
JAX goes through the eager path with JAX's draws replayed
(``tests/test_torch_tts_bf16.py``). The SPIRAL graph is held to the JAX
package's inference on the same weights: 5e-4 and equal greedy transcripts,
the CTC path's limit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech_torch.cli import export_tts, run_spiral
from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.eval.wer import ctc_greedy_decode
from tpu_speech_torch.models.grad_tts import GradTTS
from tpu_speech_torch.models.hifigan import Generator
from tpu_speech_torch.ops import _build, fused_attention, fused_logmel, fused_posconv
from tpu_speech_torch.text import symbols
from tpu_speech_torch.utils.export import export_fn, load_exported
from tests.test_torch_runner import _corpus, _flat, _padded, jax_tiny  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TTS = dict(n_vocab=20, n_spks=1, spk_emb_dim=8, n_enc_channels=16, filter_channels=32,
           filter_channels_dp=16, n_heads=2, n_enc_layers=1, enc_kernel=3, enc_dropout=0.0,
           window_size=2, n_feats=8, dec_dim=8)
VOC = dict(resblock="1", upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=8, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),), n_mels=8)
HOP = 4  # prod(upsample_rates)
TTS_TOL = 1e-5  # reloaded against eager (tests/test_export_tts.py:89)
CTC_TOL = 5e-4  # against JAX's inference


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores (a step that takes 0.5 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_models():
    model = GradTTS(**TTS).init_weights(torch.Generator().manual_seed(0)).eval()
    voc = Generator(**VOC).init_weights(torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():  # weights N(0, 0.5): the wav then follows the mel
        for m in voc.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                m.weight.mul_(50.0)
    return model, voc


def _text(b):
    x = np.zeros((b, 8), np.int32)
    x[0, :5] = [3, 1, 4, 1, 5]
    if b > 1:
        x[1] = [2, 7, 1, 8, 2, 8, 1, 8]
    return torch.from_numpy(x), torch.tensor([5, 8][:b], dtype=torch.int32)


# ---------------------------------------------------------------- utils/export.py


def test_export_fn_round_trip_of_a_callable_and_a_module(tmp_path):
    """A plain callable (its closed-over tensor a constant) and a module
    (its parameters saved) come back as programs whose ``call`` equals the
    function; an argument of another shape is refused (static shapes)."""
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))

    def fn(a, b):
        return torch.tanh(a @ w) + b, (a * 2).sum(-1)

    lin = torch.nn.Linear(4, 3)
    a, b = torch.randn(2, 4), torch.randn(2, 3)
    for f, args in ((fn, (a, b)), (lin, (a,))):
        path = str(tmp_path / "f.pt2")
        export_fn(f, args, path)
        assert os.path.getsize(path) > 0
        got = load_exported(path).call(*args)
        with torch.no_grad():
            want = f(*args)
        for g, r in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(Exception):
        load_exported(path).call(torch.randn(3, 4))


def test_load_exported_turns_tf32_off_for_a_program_on_the_card(tmp_path, monkeypatch):
    """``load_exported`` sets full fp32 (``use_full_fp32``: TF32 off for
    cuDNN and cuBLAS) when the program's tensors lie on the card, as every
    entry point does, and leaves the process's settings alone for a CPU
    program. The card branch is taken here by reporting the program as on
    the card; ``test_torch_kernels_cuda.py`` runs it with a real one."""
    from tpu_speech_torch.utils import export

    path = str(tmp_path / "lin.pt2")
    export_fn(torch.nn.Linear(4, 3), (torch.randn(2, 4),), path)
    flags = (torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32")
    saved = [getattr(o, k) for o, k in flags]
    try:
        for on_card in (False, True):
            for o, k in flags:
                setattr(o, k, True)
            monkeypatch.setattr(export, "_on_cuda", lambda program, on=on_card: on)
            load_exported(path)
            assert [getattr(o, k) for o, k in flags] == [not on_card] * 2, on_card
        monkeypatch.undo()
        assert not export._on_cuda(torch.export.load(path))
    finally:
        for (o, k), v in zip(flags, saved):
            setattr(o, k, v)


# ---------------------------------------------------------------- cli/export_tts.py


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_vocoder", [False, True], ids=["mel", "wav"])
def test_export_tts_equals_eager_and_follows_the_seed(tmp_path, with_vocoder, bf16):
    """B = 2: the reloaded program equals the eager serving function within
    1e-5 at seeds 0 and 1, the same seed gives the same output, another
    seed another one; outputs float32 with the frames (and samples) past
    the lengths zero (mel) or silence (wav: the vocoder on zeroed frames)."""
    model, voc = _tiny_models()
    fn, ex = export_tts.build_serving_fn(model, voc if with_vocoder else None, n_timesteps=2,
                                         y_max_length=16, max_text_len=8, hop_length=HOP,
                                         batch_size=2, bf16=bf16)
    assert all(p.dtype == (torch.bfloat16 if bf16 else torch.float32)
               for p in fn.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the caller's stays
    path = str(tmp_path / "tts.pt2")
    export_fn(fn, ex, path)
    art = load_exported(path)
    x, xl = _text(2)
    outs = {}
    for seed in (0, 1):
        s = torch.tensor(seed, dtype=torch.int32)
        got, lengths = art.call(x, xl, s)
        with torch.no_grad():
            want, want_lengths = fn(x, xl, s)
        assert got.dtype == torch.float32 and lengths.dtype == torch.int32
        torch.testing.assert_close(got, want, rtol=0, atol=TTS_TOL)
        assert torch.equal(lengths, want_lengths)
        outs[seed] = got
    again, _ = art.call(x, xl, torch.tensor(0, dtype=torch.int32))
    assert torch.equal(again, outs[0])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3
    if with_vocoder:
        assert got.shape == (2, 16 * HOP)
        assert all(0 < int(v) <= 16 * HOP and int(v) % HOP == 0 for v in lengths)
    else:
        assert got.shape == (2, 16, TTS["n_feats"])
        for i in range(2):
            assert int(torch.count_nonzero(got[i, int(lengths[i]):])) == 0
    assert torch.isfinite(got).all()


def test_export_tts_cli_writes_and_verifies(tmp_path, monkeypatch, capsys):
    """``main`` at a tiny config on the CPU: a .pt2 that ``--verify`` reloads
    and runs; without the vocoder files it exports mel-only; the artifact
    loads in a fresh process that imports only the port."""
    for k, v in dict(n_enc_channels=16, filter_channels=32, filter_channels_dp=16,
                     n_enc_layers=1, n_feats=8, dec_dim=8).items():
        monkeypatch.setattr(cfg, k, v)
    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    model.init_weights(torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "grad-tts.pt")
    torch.save(model.state_dict(), ckpt)
    out = str(tmp_path / "tts.pt2")
    res = export_tts.main(["-c", ckpt, "-o", out, "-t", "2", "--max-text-len", "12",
                           "--max-frames", "32", "--hifigan", str(tmp_path / "absent.pt"),
                           "--bf16", "--verify", "--device", "cpu"])
    assert "exporting mel-only" in capsys.readouterr().out
    assert not res["vocoder"] and res["finite"] and res["shape"] == (1, 32, 8)
    script = ("import sys, torch\n"
              "from tpu_speech_torch.utils.export import load_exported\n"
              "x = torch.ones((1, 12), dtype=torch.int32)\n"
              "mel, n = load_exported(sys.argv[1]).call(x, torch.tensor([12], dtype=torch.int32),"
              " torch.tensor(3, dtype=torch.int32))\n"
              "assert not any(m.startswith(('jax', 'tpu_speech.')) or m == 'tpu_speech'"
              " for m in sys.modules)\n"
              "print(tuple(mel.shape), bool(torch.isfinite(mel).all()))\n")
    run = subprocess.run([sys.executable, "-c", script, out], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().endswith("(1, 32, 8) True")


# ---------------------------------------------------------------- run_spiral --export_model


def _op_counts(path):
    ep = torch.export.load(path)
    counts = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("tpu_speech."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts


def test_run_spiral_export_model_matches_jax(tmp_path, jax_tiny):
    """``run_spiral --run_mode test --export_model`` on the tiny CTC config
    with JAX weights: the graph holds the kernels as ops (K1 once, K2's
    forward and K4 once a transformer block: 2 each here, 1 / 12 / 2 at
    SPIRAL-base), no plain kernel runs while it is traced; the reloaded
    program's log-probs on the test batch, at another batch size than the
    trace's, match JAX's inference within 5e-4 with equal greedy
    transcripts; a fresh process that imports only the port runs it."""
    params, infer = jax_tiny
    manifest, entries = _corpus(str(tmp_path))
    np.savez(tmp_path / "weights.npz", **_flat(params, "params"))
    path = str(tmp_path / "ctc.pt2")
    before = dict(_build.LAUNCHES)
    res = run_spiral.main([
        "--config_name", "spiral_tiny_ctc_char", "--model_type", "ctc_finetune",
        "--run_mode", "test", "--test_manifest", manifest, "--model_save_dir",
        str(tmp_path / "run"), "--init_chkpt_dir", str(tmp_path), "--init_chkpt_file",
        "weights.npz", "--device", "cpu", "--export_model", path])
    assert res["exported"] == path and _build.LAUNCHES == before
    assert _op_counts(path) == {"fused_logmel": 1, "fused_qkv_attention_fwd": 2,
                                "grouped_posconv": 2}
    wavs, lens = _padded(entries)
    want, want_lens = infer(jnp.asarray(wavs), jnp.asarray(lens))
    got, got_lens = load_exported(path).call(torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CTC_TOL)
    blank = 0  # blank_pos 'vocab_first' (the char decoder)
    assert (ctc_greedy_decode(got.numpy(), got_lens.numpy(), blank)
            == ctc_greedy_decode(np.asarray(want), np.asarray(want_lens), blank))
    np.save(tmp_path / "wavs.npy", wavs[:3])
    np.save(tmp_path / "lens.npy", lens[:3])
    script = ("import sys, numpy as np, torch\n"
              "from tpu_speech_torch.utils.export import load_exported\n"
              "w, n = (torch.from_numpy(np.load(p)) for p in sys.argv[2:4])\n"
              "lp, _ = load_exported(sys.argv[1]).call(w, n)\n"
              "assert not any(m.startswith(('jax', 'tpu_speech.')) or m == 'tpu_speech'"
              " for m in sys.modules)\n"
              "np.save(sys.argv[4], lp.numpy())\n")
    run = subprocess.run([sys.executable, "-c", script, path, str(tmp_path / "wavs.npy"),
                          str(tmp_path / "lens.npy"), str(tmp_path / "lp.npy")],
                         capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    np.testing.assert_allclose(np.load(tmp_path / "lp.npy"), got.numpy()[:3], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------- the registered ops


def _op_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    window = torch.hann_window(64, periodic=False)
    fb = torch.rand(8, 33, generator=g)
    logmel = (torch.randn(2, 700, generator=g), window, fb, 64, 16, 40, "power", "guard",
              2.0 ** -24, 0.0)
    mask = torch.zeros(2, 12, dtype=torch.bool)
    mask[1, 9:] = True
    qkv = (torch.randn(2, 12, 3 * 16, generator=g), 2, mask)
    posconv = (torch.randn(2, 12, 16, generator=g), torch.randn(16, 4, 5, generator=g), 4, 2)
    return {"fused_logmel": logmel, "fused_qkv_attention_fwd": qkv,
            "grouped_posconv": posconv}


@pytest.mark.parametrize("name", ["fused_logmel", "fused_qkv_attention_fwd",
                                  "grouped_posconv"])
def test_registered_op_passes_opcheck_and_equals_its_plain_version(name):
    """``torch.library.opcheck`` (schema, fake tensor, dispatch) on the CPU,
    float32 (and bf16 for K2 and K4); the op's CPU implementation is the
    plain version, bit for bit, and the public wrappers route a forward
    without autograd through it."""
    op = getattr(torch.ops.tpu_speech, name)
    args = _op_inputs()[name]
    cases = [args]
    if name == "fused_qkv_attention_fwd":
        cases.append((args[0].bfloat16(),) + args[1:])
    elif name == "grouped_posconv":
        cases.append((args[0].bfloat16(), args[1].bfloat16()) + args[2:])
    for a in cases:
        torch.library.opcheck(op, a)
    plain = {
        "fused_logmel": lambda x, w, fb, n, h, t, m, lm, g, e: fused_logmel.logmel_plain(
            x, w, fb, n_fft=n, hop_length=h, num_frames=t, mag_mode=m, log_mode=lm,
            log_guard=g, mag_eps=e),
        "fused_qkv_attention_fwd": fused_attention.qkv_attention_plain,
        "grouped_posconv": fused_posconv.grouped_conv1d_plain,
    }[name]
    for a in cases:
        assert torch.equal(op(*a), plain(*a))
    with torch.no_grad():
        x = args[0]
        if name == "fused_qkv_attention_fwd":
            out = fused_attention.fused_qkv_self_attention(x, 2, args[2])
        elif name == "grouped_posconv":
            out = fused_posconv.grouped_conv1d(x, args[1], 4, 2)
        else:
            out = fused_logmel.fused_logmel(x, args[1], args[2], n_fft=64, hop_length=16,
                                            num_frames=40, log_guard=2.0 ** -24, mag_eps=0.0)
    assert torch.equal(out, op(*args))
    gm = torch.export.export(_Wrap(name), (args[0],)).graph
    assert any(str(n.target).startswith(f"tpu_speech.{name}") for n in gm.nodes)


class _Wrap(torch.nn.Module):
    """One public wrapper call, for the traced graph."""

    def __init__(self, name):
        super().__init__()
        self.name = name
        self.rest = _op_inputs()[name][1:]

    def forward(self, x):
        if self.name == "fused_qkv_attention_fwd":
            return fused_attention.fused_qkv_self_attention(x, 2, self.rest[1])
        if self.name == "grouped_posconv":
            return fused_posconv.grouped_conv1d(x, self.rest[0], 4, 2)
        return fused_logmel.fused_logmel(x, self.rest[0], self.rest[1], n_fft=64,
                                         hop_length=16, num_frames=40)


def test_training_keeps_its_autograd_functions():
    """With autograd the wrappers take their old routes (the plain versions
    on the CPU, differentiable), not the ops, which have no backward."""
    x = torch.randn(2, 12, 16, requires_grad=True)
    w = torch.randn(16, 4, 5, requires_grad=True)
    fused_posconv.grouped_conv1d(x, w, 4, 2).sum().backward()
    qkv = torch.randn(2, 12, 48, requires_grad=True)
    fused_attention.fused_qkv_self_attention(qkv, 2, None, 0.1, 3).sum().backward()
    assert x.grad is not None and w.grad is not None and qkv.grad is not None
    with pytest.raises(RuntimeError):
        torch.ops.tpu_speech.grouped_posconv(x, w, 4, 2).sum().backward()
