"""PyTorch port, SPIRAL CTC model: conv layers, transformer, decoder, the
whole wav -> log-probs slice, the weight converters and the full-width
structure, each against the JAX package on the same weights and inputs.

Weights pass between the packages through the reference state_dict names:
JAX trees -> ``tpu_speech_torch.compat.jax_spiral.ctc_finetune_from_jax``,
port state_dicts -> ``tpu_speech.compat.torch_spiral``'s converters.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.compat import torch_spiral
from tpu_speech.eval.wer import ctc_greedy_decode
from tpu_speech.models.spiral import conv_layers as jcl
from tpu_speech.models.spiral import encoder as jenc
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.models.spiral import wav2vec as jw2v
from tpu_speech.models.spiral.ctc import CTCFinetuneModel as JaxCTCFinetuneModel
from tpu_speech_torch.compat.jax_spiral import ctc_finetune_from_jax
from tpu_speech_torch.configs.spiral import spiral_base_ctc_char, spiral_tiny_ctc_char
from tpu_speech_torch.models.spiral import conv_layers as cl
from tpu_speech_torch.models.spiral import wav2vec as w2v
from tpu_speech_torch.models.spiral.st2vec import wav_to_spec
from tpu_speech_torch.train.spiral_runner import build_model

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _randomize(module, seed, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module.eval()


def _np(t):
    return t.detach().numpy()


def _conv_params(conv):  # nn.Conv1d -> flax Conv1dTF params
    out = {"kernel": np.transpose(_np(conv.weight), (2, 1, 0))}
    if conv.bias is not None:
        out["bias"] = _np(conv.bias)
    return out


def _norm_params(norm):
    return {"scale": _np(norm.weight), "bias": _np(norm.bias)}


def _lens_mask(t, lens):
    return np.arange(t)[None, :] >= np.asarray(lens)[:, None]


def jax_encoder_cfg(cfg):
    """The JAX ST2VecConfig equal field by field to a port ST2VecConfig."""
    conv = lambda c: jenc.ConvLayerCfg(**dataclasses.asdict(c))  # noqa: E731
    blocks = tuple(
        jenc.ConvTransformerBlockCfg(
            conv_layers=tuple(conv(c) for c in b.conv_layers),
            transformer=None if b.transformer is None
            else jenc.TransformerCfg(**dataclasses.asdict(b.transformer)))
        for b in cfg.blocks)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw.update(blocks=blocks, predictor_convs=tuple(conv(c) for c in cfg.predictor_convs))
    return jst2vec.ST2VecConfig(**kw)


def jax_ctc_model(run_cfg, num_classes=28):
    """The JAX CTCFinetuneModel as SpiralFinetuneRunner builds it
    (spiral_runner.py:692-705)."""
    dec = run_cfg.model.decoder
    return JaxCTCFinetuneModel(
        jax_encoder_cfg(run_cfg.model.encoder), num_classes, dec.blank_pos,
        decoder_convs=tuple(jenc.ConvLayerCfg(**dataclasses.asdict(c))
                            for c in dec.conv_layers),
        upsample_rate=dec.upsample_rate, upsample_filters=dec.upsample_filters,
        upsample_norm=dec.upsample_norm, upsample_act=dec.upsample_act,
        upsample_dropout=dec.upsample_dropout)


@pytest.mark.parametrize("kernel,stride,in_ch", [
    (5, 2, 16), (5, 2, 15), (5, 1, 16), (3, 2, 7), (1, 1, 8), (7, 2, 128),
])
def test_tf_pad_1d_matches_jax(kernel, stride, in_ch):
    assert cl.tf_pad_1d(kernel, stride, in_ch) == jcl.tf_pad_1d(kernel, stride, in_ch)


@pytest.mark.parametrize("in_ch", [16, 15])  # both channel parities
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_tf_matches_jax(rng, in_ch, stride):
    b, t = 3, 23
    port = _randomize(cl.Conv1dTF(in_ch, 8, 5, stride), 0)
    x = rng.standard_normal((b, t, in_ch)).astype(np.float32)
    lens = np.array([23, 17, 6], np.int32)
    mask = _lens_mask(t, lens)
    y, yl, ym = jcl.Conv1dTF(8, 5, stride).apply(
        {"params": _conv_params(port.conv)}, jnp.asarray(x), jnp.asarray(lens),
        jnp.asarray(mask))
    with torch.no_grad():
        oy, ol, om = port(torch.tensor(x), torch.tensor(lens), torch.tensor(mask))
    np.testing.assert_allclose(oy.numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(yl))  # ceil(len / stride)
    np.testing.assert_array_equal(om.numpy(), np.asarray(ym))


@pytest.mark.parametrize("norm_type,act", [("ln", "relu"), ("ln", None), (None, "relu"), ("bn", "relu")])
def test_conv_norm_act_matches_jax(rng, norm_type, act):
    b, t, c = 2, 19, 12
    port = _randomize(cl.ConvNormAct(c, 10, (5,), (2,), norm_type, act, 0.1), 1)
    params = {"conv": _conv_params(port.conv.conv)}
    variables = {"params": params}
    if norm_type is not None:
        params["norm"] = _norm_params(port.norm)
    if norm_type == "bn":
        with torch.no_grad():
            port.norm.running_mean.copy_(torch.randn(10) * 0.2)
            port.norm.running_var.copy_(torch.rand(10) + 0.5)
        variables["batch_stats"] = {"norm": {"mean": _np(port.norm.running_mean),
                                             "var": _np(port.norm.running_var)}}
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    lens = np.array([19, 8], np.int32)
    mask = _lens_mask(t, lens)
    ref, rl, _ = jcl.ConvNormAct(10, (5,), (2,), norm_type, act, 0.1).apply(
        variables, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(mask))
    with torch.no_grad():
        out, ol, _ = port(torch.tensor(x), torch.tensor(lens), torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(rl))


def test_layer_norm_epsilons_follow_the_jax_modules():
    """flax's default 1e-6 in the transformer, 1e-5 in the conv blocks."""
    enc = w2v.TransformerEncoder(16, 1, 32, 2, conv_pos=4, conv_pos_groups=2)
    eps = {n: m.eps for n, m in enc.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {"layers.0.self_attn_layer_norm": 1e-6,
                   "layers.0.final_layer_norm": 1e-6, "layer_norm": 1e-6}
    assert cl.ConvNormAct(8, 8, (5,), (1,), "ln").norm.eps == 1e-5
    assert cl.ProjUpsampling(8, 8, (5,), 4, "ln").norm.eps == 1e-5


def test_proj_upsampling_order_matches_jax(rng):
    """(B, T, rate*F) -> (B, T*rate, F) is a channels-last reshape."""
    b, t, c, f, rate = 2, 7, 12, 6, 4
    port = _randomize(cl.ProjUpsampling(c, f, (5,), rate, "ln", "relu"), 2)
    params = {"proj": _conv_params(port.proj.conv.conv), "norm": _norm_params(port.norm)}
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    lens = np.array([7, 4], np.int32)
    ref, rl = jcl.ProjUpsampling(f, (5,), rate, "ln", "relu").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        out, ol = port(torch.tensor(x), torch.tensor(lens))
    assert out.shape == (b, t * rate, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(rl))


@pytest.mark.parametrize("k", [8, 7])  # even kernel: SamePad trim
def test_conv_positional_embedding_matches_jax(rng, k):
    b, t, c, g = 2, 13, 16, 4
    port = _randomize(w2v.ConvPositionalEmbedding(c, k, g), 4)
    params = {"v": np.transpose(_np(port.weight_v), (2, 1, 0)),
              "g": _np(port.weight_g).reshape(-1), "bias": _np(port.bias)}
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    ref = jw2v.ConvPositionalEmbedding(c, k, g).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.tensor(x))
    assert out.shape == (b, t, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("layer_norm_first", [True, False])
def test_transformer_encoder_matches_jax(rng, layer_norm_first):
    """Weights go port -> reference names -> the JAX converter."""
    b, t, e = 2, 14, 16
    port = _randomize(w2v.TransformerEncoder(
        e, 2, 32, 2, 0.0, 0.0, 0.0, layer_norm_first=layer_norm_first,
        conv_pos=6, conv_pos_groups=2), 5)
    sd = {f"t.{k}": v for k, v in port.state_dict().items()}
    params, used = {}, set()
    torch_spiral._convert_transformer(sd, used, "t", params, ())
    assert used == set(sd)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    mask = _lens_mask(t, [14, 5])
    ref = jw2v.TransformerEncoder(
        e, 2, 32, 2, 0.0, 0.0, 0.0, layer_norm_first=layer_norm_first,
        conv_pos=6, conv_pos_groups=2).apply({"params": params}, jnp.asarray(x),
                                             jnp.asarray(mask))
    with torch.no_grad():
        out = port(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


@pytest.fixture(scope="module")
def tiny():
    """The tiny CTC char config in both packages with the JAX init's weights."""
    cfg = spiral_tiny_ctc_char()
    jmodel = jax_ctc_model(cfg)
    t = 112
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, t, 16)), jnp.full((1,), t),
        train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    return cfg, jmodel, params


def test_whole_slice_matches_jax(rng, tiny):
    """wav -> wav_to_spec -> CTCFinetuneModel(train=False) -> log-probs and
    greedy transcripts, JAX against the port on the same weights."""
    cfg, jmodel, params = tiny
    port = build_model(cfg, 28)
    port.load_state_dict(ctc_finetune_from_jax(params, {}), strict=True)
    port.eval()
    wavs = (rng.standard_normal((3, 16000)) * 0.1).astype(np.float32)
    lens = np.array([16000, 9000, 4321], np.int32)
    for i, n in enumerate(lens):
        wavs[i, n:] = 0.0
    jcfg = jax_encoder_cfg(cfg.model.encoder)

    @jax.jit
    def infer(params, wavs, lens):  # the JAX runner's _infer_fn
        specs, spec_lens = jst2vec.wav_to_spec(jcfg, wavs, lens)
        return jmodel.apply({"params": params}, specs, spec_lens, train=False)

    ref, ref_lens = infer(params, jnp.asarray(wavs), jnp.asarray(lens))
    with torch.no_grad():
        out, out_lens = port(*wav_to_spec(cfg.model.encoder, torch.tensor(wavs),
                                          torch.tensor(lens)))
    assert out.shape == ref.shape == (3, 56, 29)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    # the SPIRAL-tower CPU bound of PARITY.md:175-176
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)
    blank = port.blank_idx
    assert blank == jmodel.blank_idx == 28
    assert (ctc_greedy_decode(out.numpy(), out_lens.numpy(), blank)
            == ctc_greedy_decode(np.asarray(ref), np.asarray(ref_lens), blank))


def _leaves(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], pre + (k,))
    else:
        yield pre, np.asarray(tree)


def test_weight_round_trip_is_exact(tiny):
    """JAX tree -> port state_dict -> the JAX package's convert_ctc_finetune
    gives the JAX tree back exactly, and the port loads it strictly."""
    cfg, _, params = tiny
    sd = ctc_finetune_from_jax(params, {})
    build_model(cfg, 28).load_state_dict(sd, strict=True)
    (enc, enc_bs, teacher), (dec, dec_bs) = torch_spiral.convert_ctc_finetune(sd)
    assert enc_bs == {} and teacher == {} and dec_bs == {}
    back = dict(_leaves({"encoder": enc, "decoder": dec}))
    ref = dict(_leaves(params))
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg="/".join(k))


def test_weight_round_trip_carries_batchnorm_stats():
    cfg = spiral_tiny_ctc_char()
    cfg.model.decoder = dataclasses.replace(cfg.model.decoder, conv_layers=tuple(
        dataclasses.replace(c, norm_type="bn") for c in cfg.model.decoder.conv_layers))
    port = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(7))
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-1, 1)
                m.running_var.uniform_(0.5, 2)
    sd = port.state_dict()
    (enc, _, _), (dec, dec_bs) = torch_spiral.convert_ctc_finetune(sd)
    assert set(dec_bs) == {"conv_0", "conv_1", "conv_2"}
    back = ctc_finetune_from_jax({"encoder": enc, "decoder": dec}, {"decoder": dec_bs})
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, check_dtype=False)


def test_converter_is_strict(tiny):
    _, _, params = tiny
    extra = jax.tree.map(lambda x: x, params)
    extra["decoder"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        ctc_finetune_from_jax(extra, {})
    missing = jax.tree.map(lambda x: x, params)
    del missing["decoder"]["decoder_proj"]["bias"]
    with pytest.raises(KeyError):
        ctc_finetune_from_jax(missing, {})


def _cli_config(name):
    sys.path.insert(0, os.path.join(REPO, "cli", "conf", "spiral"))
    try:
        return importlib.import_module(name).cfg
    finally:
        sys.path.pop(0)


def test_full_width_config_matches_the_cli_config_field_by_field():
    ours = dataclasses.asdict(spiral_base_ctc_char())
    theirs = dataclasses.asdict(_cli_config("spiral_base_finetune_ls100_char"))
    assert ours == theirs


def test_full_width_structure_matches_jax_without_compute():
    """jax.eval_shape of the JAX model from the cli config against the port's
    full-width state_dict shapes (built on the meta device: no memory)."""
    cli_cfg = _cli_config("spiral_base_finetune_ls100_char")
    jmodel = jax_ctc_model(cli_cfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 128)), jnp.full((1,), 64),
                            train=False))["params"]
    expected = {k: tuple(v.shape) for k, v in _leaves(jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))}
    port = build_model(spiral_base_ctc_char(), 28, device="meta")
    sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
          for k, v in port.state_dict().items()}
    (enc, _, _), (dec, _) = torch_spiral.convert_ctc_finetune(sd)
    got = {k: v.shape for k, v in _leaves({"encoder": enc, "decoder": dec})}
    assert got == expected
    n_params = sum(int(np.prod(s)) for s in expected.values())
    assert n_params == sum(p.numel() for p in port.parameters())
    assert 100e6 < n_params < 105e6
