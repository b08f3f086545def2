"""PyTorch port, streaming SPIRAL against the JAX package on the CPU: the
chunked attention mask, the causal conv layers (``hardtanh`` too) and
positional conv, the offline streaming-mode model and one finetune step, the
streaming featurizer, the chunk step (``make_stream_step``) and the host
transcriber (``StreamingTranscriber``), and ``run_spiral --streaming_eval``.

Inputs come from numpy seeds; the weights are JAX's init converted to the
port's state_dict. The model is the tiny streaming model of
``tests/test_streaming.py`` (16 mels, chunks of 16 spec frames, two chunks of
left context, a 2x upsampling char head). The JAX chunk step carries its
normalization sums in float32 and the port's in float64, as the port's
offline featurizer does (ROADMAP Queue 3).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_speech.models.spiral import conv_layers as jcl
from tpu_speech.models.spiral import ctc as jctc
from tpu_speech.models.spiral import encoder as jenc
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.models.spiral import streaming as jstreaming
from tpu_speech.models.spiral import wav2vec as jw2v
from tpu_speech.models.spiral.features import filterbank_features as jax_features
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.compat.jax_spiral import ctc_finetune_from_jax
from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.eval.wer import ctc_greedy_decode
from tpu_speech_torch.models.spiral import conv_layers as cl
from tpu_speech_torch.models.spiral import streaming
from tpu_speech_torch.models.spiral import wav2vec as w2v
from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.encoder import (
    ConvLayerCfg,
    ConvTransformerBlockCfg,
    StreamingCfg,
    TransformerCfg,
)
from tpu_speech_torch.models.spiral.features import filterbank_features
from tpu_speech_torch.models.spiral.st2vec import ST2VecConfig, wav_to_spec
from tpu_speech_torch.ops import _build
from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
from tpu_speech_torch.train.spiral import batch_to_device
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner, build_model

from tests.test_torch_finetune import _assert_grads_close, _port_tree, _sgd_grads
from tests.test_torch_spiral_ctc import jax_ctc_model, jax_encoder_cfg
from tests.test_torch_subword_slice import _causal_float64

jax.config.update("jax_default_matmul_precision", "highest")

SR = 16000
HOP = 160
CHUNK = 16  # spec frames a chunk
NFILT = 16
LAYER_ATOL = 1e-5  # a layer, the same arithmetic in both packages
MODEL_ATOL = 1e-5  # the offline model on equal specs
STEP_ATOL = 2e-4  # the chunk step (tests/test_streaming.py:138)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def jax_stream_cfg(cfg):
    """The JAX ST2VecConfig equal to a port streaming ST2VecConfig."""
    s = cfg.streaming
    return dataclasses.replace(
        jax_encoder_cfg(dataclasses.replace(cfg, streaming=None)),
        streaming=None if s is None else jenc.StreamingCfg(s.chunk_frames, s.left_chunks))


def tiny_config(chunk=CHUNK, left=2):
    """``tests/test_streaming.py::tiny_streaming_model``'s encoder."""
    blocks = (
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(24, (5,), (2,), "ln", "relu", 0.0),
                         ConvLayerCfg(24, (1,), (1,), "ln", None, 0.0)),
            transformer=TransformerCfg(2, 24, 48, 2, 0.0, attention_dropout=0.0,
                                       conv_pos=8, conv_pos_groups=2)),
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(32, (5,), (2,), "ln", "relu", 0.0),),
            transformer=TransformerCfg(1, 32, 64, 2, 0.0, attention_dropout=0.0,
                                       conv_pos=8, conv_pos_groups=2)),
    )
    return ST2VecConfig(blocks=blocks, num_features=NFILT,
                        streaming=StreamingCfg(chunk_frames=chunk, left_chunks=left))


DECODER = dict(decoder_convs=(ConvLayerCfg(16, (5,), (1,), None, "relu", 0.0),),
               upsample_rate=2, upsample_filters=16)


def _jax_decoder():
    dec = DECODER["decoder_convs"][0]
    return dict(DECODER, decoder_convs=(jenc.ConvLayerCfg(**dataclasses.asdict(dec)),))


@pytest.fixture(scope="module")
def tiny():
    """(port model, JAX model, JAX params): JAX's init at PRNGKey(0) through
    the converter."""
    cfg = tiny_config()
    jmodel = jctc.CTCFinetuneModel(encoder_cfg=jax_stream_cfg(cfg), num_classes=6,
                                   **_jax_decoder())
    t = 4 * CHUNK
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((2, t, NFILT)), jnp.full((2,), t, jnp.int32),
        train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    port = CTCFinetuneModel(cfg, 6, **DECODER)
    port.load_state_dict(ctc_finetune_from_jax(params, {}), strict=True)
    return port.eval(), jmodel, params


def offline_feats(wav, lens, torch_side):
    """The streaming-mode featurizer, offline, no padding to 16 frames."""
    kw = dict(sample_rate=SR, nfilt=NFILT, normalize="per_feature_causal",
              do_normalize_time_domain=False, pad_to=0)
    if torch_side:
        return filterbank_features(torch.tensor(wav), torch.tensor(lens), **kw)
    return jax_features(jnp.asarray(wav), jnp.asarray(lens), **kw)


def preemph_padded(wav):
    """Preemphasis and the 256-sample reflect pads (features.py:86-92)."""
    p = wav.copy()
    p[:, 1:] = wav[:, 1:] - 0.97 * wav[:, :-1]
    return np.pad(p, ((0, 0), (256, 256)), mode="reflect")


def _greedy(log_probs, lens, blank):
    return ctc_greedy_decode(np.asarray(log_probs), np.asarray(lens), blank)


# ---- layers ------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk,left", [(8, 2, 1), (37, 4, 2), (64, 16, 2), (5, 8, 3)])
def test_chunked_attention_mask_equals_jax(t, chunk, left):
    np.testing.assert_array_equal(w2v.chunked_attention_mask(t, chunk, left).numpy(),
                                  np.asarray(jw2v.chunked_attention_mask(t, chunk, left)))


@pytest.mark.parametrize("stride,act,norm", [(1, "hardtanh", "ln"), (2, "hardtanh", None),
                                             (2, "relu", "ln"), (1, None, None)])
def test_causal_conv_norm_act_matches_jax(rng, stride, act, norm):
    b, t, cin, cout, k = 3, 21, 7, 10, 5
    port = cl.ConvNormAct(cin, cout, (k,), (stride,), norm, act, causal=True).eval()
    g = torch.Generator().manual_seed(stride)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    x = rng.standard_normal((b, t, cin)).astype(np.float32) * 2.0  # past the clip
    lens = np.array([21, 15, 6])
    mask = np.arange(t)[None, :] >= lens[:, None]
    params = {"conv": {"kernel": np.transpose(_np(port.conv.conv.weight), (2, 1, 0))}}
    if port.conv.conv.bias is not None:
        params["conv"]["bias"] = _np(port.conv.conv.bias)
    if norm:
        params["norm"] = {"scale": _np(port.norm.weight), "bias": _np(port.norm.bias)}
    jmod = jcl.ConvNormAct(cout, (k,), (stride,), norm, act, causal=True)
    want, wlens, _ = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(lens),
                                jnp.asarray(mask))
    with torch.no_grad():
        got, glens, _ = port(torch.tensor(x), torch.tensor(lens), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    if act == "hardtanh":
        assert got.abs().max() <= 1.0 and (got.abs() == 1.0).any()


def test_causal_positional_conv_plain_matches_jax(rng):
    b, t, c, k, g = 2, 40, 32, 16, 4
    port = w2v.ConvPositionalEmbedding(c, k, g, causal=True)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    v = np.transpose(_np(port.weight_v), (2, 1, 0))  # (C, C/g, k) -> (k, C/g, C)
    params = {"v": v, "g": _np(port.weight_g).reshape(k),
              "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    with torch.no_grad():
        port.bias.copy_(torch.tensor(params["bias"]))
        got = port(torch.tensor(x))
    want = jw2v.ConvPositionalEmbedding(c, k, g, causal=True).apply(
        {"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, rtol=0)
    # causal: frame t reads frames <= t only
    x2 = x.copy()
    x2[:, 25:] = 0.0
    with torch.no_grad():
        np.testing.assert_array_equal(port(torch.tensor(x2))[:, :25].numpy(),
                                      got[:, :25].numpy())


# ---- the offline streaming-mode model ----------------------------------------

def test_offline_streaming_model_matches_jax(rng, tiny):
    port, jmodel, params = tiny
    b, t = 3, 5 * CHUNK
    specs = rng.standard_normal((b, t, NFILT)).astype(np.float32)
    lens = np.array([t, 61, 23], np.int32)
    want, wlens = jmodel.apply({"params": params}, jnp.asarray(specs), jnp.asarray(lens),
                               train=False)
    with torch.no_grad():
        got, glens = port(torch.tensor(specs), torch.tensor(lens))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    for i, n in enumerate(np.asarray(wlens)):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n],
                                   atol=MODEL_ATOL, rtol=0)


def test_streaming_wav_to_spec_follows_the_causal_rule(rng):
    """The streaming front end: per_feature_causal without the time-domain
    peak normalization, held to JAX by the rule of
    ``test_torch_subword_slice.py``'s causal test (within 1e-4 of the
    float64 normalization of the same log-mels, and no farther from JAX
    than JAX is from it)."""
    cfg = tiny_config()
    wavs = (rng.standard_normal((2, 9000)) * 0.1).astype(np.float32)
    lens = np.array([9000, 6100], np.int32)
    wavs[1, 6100:] = 0.0
    got, glens = wav_to_spec(cfg, torch.tensor(wavs), torch.tensor(lens))
    want, wlens = jst2vec.wav_to_spec(jax_stream_cfg(cfg), jnp.asarray(wavs), jnp.asarray(lens))
    raw, _ = jax_features(jnp.asarray(wavs), jnp.asarray(lens), sample_rate=SR, nfilt=NFILT,
                          normalize="none", do_normalize_time_domain=False,
                          use_fused_kernel=False)
    ref = _causal_float64(raw, lens)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.all(np.abs(got - want) <= np.abs(want - ref) + 1e-4)


def test_streaming_finetune_step_matches_jax_sgd(monkeypatch):
    """One streaming-mode finetune step at the tiny CTC config (chunks of 32
    spec frames), dropout, dither and masks off, optax.sgd(1.0) on both
    sides, on equal specs: both steps read the specs of JAX's streaming front
    end, computed once (its float32 causal sums land by their summation
    order, which a jitted step would change; the port's float64 ones are
    held to them by ``test_streaming_wav_to_spec_follows_the_causal_rule``).
    The loss within 1e-5 relative, each gradient within the finetune slice's
    1e-4 x its max|g| (``tests/test_torch_finetune.py``)."""
    from tests.test_torch_finetune import _batch, _tiny
    from tpu_speech_torch.train import finetune

    batch = _batch()
    specs = None

    def jax_front_end(cfg, wavs, wav_lens, **kw):
        return specs

    def port_front_end(cfg, wavs, wav_lens, **kw):
        return tuple(torch.tensor(np.asarray(a)) for a in specs)

    cfg, _, _ = _tiny()
    cfg.model.encoder = dataclasses.replace(
        cfg.model.encoder, streaming=StreamingCfg(chunk_frames=32, left_chunks=2))
    jmodel, jcfg = jax_ctc_model_streaming(cfg)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    specs = jst2vec.wav_to_spec(jcfg, jnp.asarray(batch["wavs"]), jnp.asarray(batch["wav_lens"]))
    monkeypatch.setattr(jctc, "wav_to_spec", jax_front_end)
    monkeypatch.setattr(finetune, "wav_to_spec", port_front_end)
    tx = optax.sgd(1.0)
    jstate = jctc.CTCTrainState(jnp.zeros((), jnp.int32), params, {}, tx.init(params))
    jstep = jctc.make_finetune_step(jmodel, jcfg, tx, freeze_finetune_updates=1)
    jnew, jm = jstep(jstate, batch, jax.random.PRNGKey(3), iteration=1)
    model = build_model(cfg, 28)
    model.load_state_dict(ctc_finetune_from_jax(params, {}), strict=True)
    state = make_finetune_state(model, lambda ps: torch.optim.SGD(ps, lr=1.0))
    m = finetune_step(state, batch_to_device(batch, "cpu"), DropoutRng.seeded(0, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_grads_close(_sgd_grads(params, _port_tree(state.model)),
                        _sgd_grads(params, jax.device_get(jnew.params)))


def jax_ctc_model_streaming(cfg):
    jcfg = jax_stream_cfg(cfg.model.encoder)
    jmodel = dataclasses.replace(jax_ctc_model(cfg), encoder_cfg=jcfg)
    return jmodel, jcfg


# ---- the chunk step and the transcriber ---------------------------------------

def _chunk_windows(wav, n_chunks):
    padded = preemph_padded(wav)
    w = CHUNK * HOP
    return [padded[:, j * w:j * w + w + 352] for j in range(n_chunks)]


def test_stream_step_matches_jax_and_the_offline_forward(tiny):
    """Four whole chunks at B = 2: each chunk's log-probs within 2e-4 of the
    JAX step's on the same windows, and the concatenation within 2e-4 of the
    port's own offline streaming-mode forward (the caches, masks and carried
    statistics reproduce the offline model). The step launches nothing on
    the CPU."""
    port, jmodel, params = tiny
    rng = np.random.default_rng(0)
    n_chunks, batch = 4, 2
    n = n_chunks * CHUNK * HOP
    wav = (rng.standard_normal((batch, n)) * 0.1).astype(np.float32)
    jinit, jstep = jstreaming.make_stream_step(jmodel, params)
    init_state, step = streaming.make_stream_step(port)
    jst, st = jinit(batch), init_state(batch)
    got, want = [], []
    before = dict(_build.LAUNCHES)
    for window in _chunk_windows(wav, n_chunks):
        jst, jlp, _, jlens = jstep(jst, jnp.asarray(window), jnp.full((batch,), CHUNK, np.int32))
        st, lp, ids, lens = step(st, torch.tensor(window), torch.full((batch,), CHUNK))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=STEP_ATOL, rtol=0)
        assert torch.equal(ids, lp.argmax(-1))
        got.append(lp.numpy())
        want.append(np.asarray(jlp))
    assert _build.LAUNCHES == before
    got = np.concatenate(got, axis=1)
    feats, feat_lens = offline_feats(wav, np.full((batch,), n), torch_side=True)
    with torch.no_grad():
        off, off_lens = port(feats, feat_lens)
    assert got.shape[1] == int(off_lens[0])
    np.testing.assert_allclose(got, off.numpy()[:, :got.shape[1]], atol=STEP_ATOL, rtol=0)


def test_streaming_transcriber_matches_jax_and_offline_greedy(tiny):
    """Feeds of [1000, 3171, 40, 2500, 9000] samples over 3.4 chunks and a
    partial last chunk through flush(): the collapsed ids equal the JAX
    transcriber's and the port's offline greedy transcript."""
    port, jmodel, params = tiny
    rng = np.random.default_rng(1)
    n = int(3.4 * CHUNK * HOP)
    wav = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
    feats, feat_lens = offline_feats(wav, np.array([n]), torch_side=True)
    with torch.no_grad():
        off, off_lens = port(feats, feat_lens)
    ref = _greedy(off.numpy(), off_lens.numpy(), port.blank_idx)[0]

    def run(tr):
        pos, i, sizes = 0, 0, [1000, 3171, 40, 2500, 9000]
        while pos < n:
            k = min(sizes[i % len(sizes)], n - pos)
            tr.feed(wav[:, pos:pos + k])
            pos, i = pos + k, i + 1
        return tr.flush()[0]

    got = run(streaming.StreamingTranscriber(port, batch=1))
    want = run(jstreaming.StreamingTranscriber(jmodel, params, batch=1))
    assert got == want == ref
    assert len(got) > 0


def test_feat_spec_equals_jax():
    assert dataclasses.asdict(streaming.feat_spec()) == dataclasses.asdict(
        jstreaming.feat_spec())
    spec = streaming.feat_spec(nfilt=NFILT)
    assert (spec.pad, spec.overlap, spec.n_fft) == (256, 352, 512)


def test_stream_step_refuses_an_offline_model():
    cfg = dataclasses.replace(tiny_config(), streaming=None)
    with pytest.raises(ValueError, match="streaming-mode model"):
        streaming.make_stream_step(CTCFinetuneModel(cfg, 6, **DECODER))


# ---- the CLI -----------------------------------------------------------------

def _stream_corpus(root, n=3, seed=0):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        wav = (rng.standard_normal(int(SR * (0.45 + 0.15 * i))) * 0.1).astype(np.float32)
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, wav, SR)
        entries.append({"audio_filepath": path, "duration": len(wav) / SR,
                        "text": "hello world"})
    with open(os.path.join(root, "manifest.json"), "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    return entries


def test_run_spiral_streaming_eval_cli(tmp_path, capsys):
    """``run_spiral --config_name spiral_tiny_stream_test --run_mode test
    --streaming_eval true`` on a 3-utterance manifest: the streaming
    transcripts equal the port's offline greedy ones on each utterance at its
    own length, and the JAX CLI's line is printed."""
    data = tmp_path / "data"
    data.mkdir()
    entries = _stream_corpus(str(data))
    res = run_spiral.main([
        "--config_name", "spiral_tiny_stream_test", "--manifest_dir", str(data),
        "--model_save_dir", str(tmp_path / "logs"), "--model_type", "ctc_finetune",
        "--run_mode", "test", "--streaming_eval", "true", "--resume_if_exists", "false",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"TEST (streaming): WER = {res['wer']:.4f} | CER = {res['cer']:.4f} | 3 utts" in out
    from tpu_speech_torch.text.tokenizers import CharTokenizer

    cfg = CONFIGS["spiral_tiny_stream_test"]()
    runner = SpiralFinetuneRunner(cfg, str(tmp_path / "ref"), CharTokenizer(cfg.model.labels),
                                  device="cpu")
    from tpu_speech_torch.data.wav import read_wav

    offline = []
    for e in entries:
        wav, _ = read_wav(e["audio_filepath"])
        lp, lens = runner.infer(wav[None], np.array([len(wav)], np.int32))
        offline.append(runner.tokenizer.ids_to_text(
            _greedy(lp.numpy(), lens.numpy(), runner.model.blank_idx)[0]))
    assert res["hyps"] == offline
    assert res["n"] == 3


def test_streaming_eval_needs_a_streaming_config(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _stream_corpus(str(data), n=1)
    with pytest.raises(ValueError, match="streaming-mode model"):
        run_spiral.main([
            "--config_name", "spiral_tiny_ctc_char", "--test_manifest",
            str(data / "manifest.json"), "--model_save_dir", str(tmp_path / "logs"),
            "--model_type", "ctc_finetune", "--run_mode", "test", "--streaming_eval", "true",
            "--device", "cpu"])
