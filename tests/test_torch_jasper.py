"""PyTorch port, the Jasper/QuartzNet conv-CTC family against the JAX package
on the CPU: each Jasper block form (separable and dense, stride 2 with and
without the residual, dilation 2, the four activations) in eval and train
mode, ``EncDecCTCModel`` from specs and from wavs, the BPE model and its
decode, the converters both ways, and three train steps with AdamW and the
global-norm clip.

Inputs come from numpy seeds; the weights are JAX's init moved off it by a
seeded perturbation (BatchNorm statistics too) and converted by
``compat/jax_ctc_models.py``. Sizes are ``tests/test_ctc_models.py``'s
``TINY``; dropout is off. The helpers at the bottom serve
``tests/test_torch_conformer.py`` too.
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral import ctc_models as jc
from tpu_speech.models.spiral import jasper as jj
from tpu_speech.models.spiral.ctc import CTCTrainState as JaxCTCState
from tpu_speech.models.spiral.ctc import ctc_loss as jax_ctc_loss
from tpu_speech_torch.compat.jax_ctc_models import (
    conv_asr_encoder_from_jax,
    enc_dec_ctc_from_jax,
    enc_dec_ctc_to_jax,
)
from tpu_speech_torch.models.spiral import ctc_models as pc
from tpu_speech_torch.models.spiral import jasper as pj
from tpu_speech_torch.models.spiral.ctc import ctc_loss
from tpu_speech_torch.text.tokenizers import SubwordTokenizer
from tpu_speech_torch.train.optim import AdamW

from tests.test_ctc_models import TINY

jax.config.update("jax_default_matmul_precision", "highest")

FWD_RTOL = 5e-5  # x max(1, max|JAX|): the same arithmetic in both packages
WAV_ATOL = 5e-4  # from wavs: two fp32 rfft pipelines, normalized per feature
STEP_LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().cpu().numpy()


def port_blocks(blocks):
    return tuple(pj.JasperBlockCfg(**dataclasses.asdict(b)) for b in blocks)


def port_cfg(jcfg):
    kw = dataclasses.asdict(jcfg)
    kw["blocks"] = port_blocks(jcfg.blocks)
    return pc.EncDecCTCConfig(**kw)


def perturbed(variables, seed):
    """JAX variables (numpy) moved off their init: params + 0.1 N(0, 1), the
    BatchNorm means + 0.1 N(0, 1) and variances |.| + 0.5."""
    r = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(
        np.float32), jax.tree.map(np.asarray, dict(variables)))
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else a, out["batch_stats"])
    return out


def specs_batch(seed, b, t, f, lens):
    r = np.random.default_rng(seed)
    specs = r.standard_normal((b, t, f)).astype(np.float32)
    return specs, np.asarray(lens, np.int32)


def jit_apply(module):
    """``module.apply`` compiled once (eager flax compiles each op)."""
    return jax.jit(module.apply, static_argnames=("train", "mutable", "method"))


def jit_init(module, *args):
    return jax.jit(module.init)({"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(1)}, *map(jnp.asarray, args))


def assert_close_scaled(got, want, rtol, what=""):
    want = np.asarray(want)
    bound = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=what)


def assert_valid_frames_close(got, want, lens, rtol):
    """Log-probs compared on each row's valid frames only (the padded tail
    is the decoder's response to zeros, which neither package masks)."""
    for i, n in enumerate(np.asarray(lens)):
        assert_close_scaled(_np(got)[i, :n], np.asarray(want)[i, :n], rtol, f"row {i}")


# ---- blocks -------------------------------------------------------------------

BLOCKS = {
    "separable": jj.JasperBlockCfg(12, 5, repeat=2, separable=True, dropout=0.0),
    "dense": jj.JasperBlockCfg(12, 5, repeat=2, dropout=0.0),
    "stride2_residual": jj.JasperBlockCfg(12, 5, repeat=2, stride=2, dropout=0.0),
    "stride2_plain": jj.JasperBlockCfg(12, 7, repeat=1, stride=2, residual=False,
                                       dropout=0.0),
    "dilation2": jj.JasperBlockCfg(12, 5, repeat=2, dilation=2, separable=True, dropout=0.0),
    "hardtanh": jj.JasperBlockCfg(12, 3, repeat=2, activation="hardtanh", dropout=0.0),
    "selu": jj.JasperBlockCfg(12, 3, repeat=2, activation="selu", dropout=0.0),
    "swish": jj.JasperBlockCfg(12, 3, repeat=2, activation="swish", dropout=0.0,
                               residual=False),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_jasper_block_matches_jax(name):
    """Eval mode (running statistics) and train mode (batch statistics over
    every frame, the running ones moved as flax's) within 5e-5 x
    max(1, max|JAX|), the lengths equal. The stride-2 residual block keeps
    the JAX quirk: no residual and no last activation."""
    jcfg = BLOCKS[name]
    x, lens = specs_batch(3, 2, 23, 8, [23, 14])
    enc = jj.ConvASREncoder((jcfg,))
    variables = perturbed(enc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                                   jnp.asarray(lens)), 7)
    encoder = pj.ConvASREncoder(8, port_blocks((jcfg,)))
    encoder.load_state_dict(conv_asr_encoder_from_jax(variables), strict=True)
    port = encoder.blocks[0]
    if name == "stride2_residual":
        assert port.res_proj is None and "res_proj" not in variables["params"]["block_0"]
    blk, variables = jj.JasperBlock(jcfg), {k: v["block_0"] for k, v in variables.items()}
    apply = blk.apply
    want, want_lens = apply(variables, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = port.eval()(torch.tensor(x), torch.tensor(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert_close_scaled(_np(got), want, FWD_RTOL, "eval")
    (want, _), upd = apply(variables, jnp.asarray(x), jnp.asarray(lens), train=True,
                           mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad():
        got, _ = port.train()(torch.tensor(x), torch.tensor(lens))
    assert_close_scaled(_np(got), want, FWD_RTOL, "train")
    for r in range(jcfg.repeat):
        for stat, buf in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                _np(getattr(port.bn[r], buf)), np.asarray(upd["batch_stats"][f"bn_{r}"][stat]),
                rtol=1e-5, atol=1e-6)


def test_activations_are_the_registry():
    x = torch.linspace(-3, 3, 61)
    for name, fn in jj.ACTIVATIONS.items():
        np.testing.assert_allclose(pj.ACTIVATIONS[name](x).numpy(),
                                   np.asarray(fn(jnp.asarray(x.numpy()))), atol=1e-6)
    assert sorted(pj.ACTIVATIONS) == sorted(jj.ACTIVATIONS)


def test_configs_and_preset_equal_jax():
    for f in (256, 16):
        assert [dataclasses.asdict(b) for b in pc.quartznet5x3_blocks(f)] == [
            dataclasses.asdict(b) for b in jc.quartznet5x3_blocks(f)]
    assert dataclasses.asdict(pc.EncDecCTCConfig(29)) == dataclasses.asdict(
        jc.EncDecCTCConfig(29))
    assert dataclasses.asdict(port_cfg(TINY)) == dataclasses.asdict(TINY)


# ---- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(JAX model, perturbed variables, the port's model in eval mode)."""
    specs, lens = specs_batch(0, 2, 40, TINY.n_mels, [40, 31])
    jmodel = jc.EncDecCTCModel(TINY)
    variables = perturbed(jit_init(jmodel, specs, lens), 11)
    port = pc.EncDecCTCModel(port_cfg(TINY), device="cpu")
    port.load_state_dict(enc_dec_ctc_from_jax(variables), strict=True)
    return jmodel, variables, port.eval()


def test_converters_round_trip_exactly(tiny):
    _, variables, port = tiny
    sd = enc_dec_ctc_from_jax(variables)
    back = enc_dec_ctc_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    again = enc_dec_ctc_from_jax(enc_dec_ctc_to_jax(port.state_dict()))
    assert again.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(again[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unconsumed"):
        enc_dec_ctc_from_jax({"params": dict(variables["params"], extra={"w": np.ones(2)}),
                              "batch_stats": variables["batch_stats"]})


def test_forward_from_specs_matches_jax(tiny):
    jmodel, variables, port = tiny
    specs, lens = specs_batch(5, 3, 48, TINY.n_mels, [48, 33, 17])
    want, want_lens = jit_apply(jmodel)(variables, jnp.asarray(specs), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = port(torch.tensor(specs), torch.tensor(lens))
    assert got.shape == want.shape and port.blank_idx == jmodel.blank_idx == TINY.num_classes
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert_close_scaled(_np(got), want, FWD_RTOL)


def wav_batch(seed, lens, n):
    r = np.random.default_rng(seed)
    wavs = np.zeros((len(lens), n), np.float32)
    for i, m in enumerate(lens):
        t = np.arange(m) / 16000
        wavs[i, :m] = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) * (1 + np.sin(7 * t))
                       + 0.05 * r.standard_normal(m))
    return wavs, np.asarray(lens, np.int32)


def check_wav_path(jmodel, variables, port, lens=(4800, 3100), n=4800, seed=9):
    """featurize (the port's plain K1 path against JAX's rfft path) then the
    model: log-probs within 5e-4 on the valid frames and equal greedy ids."""
    from tpu_speech.eval.wer import ctc_greedy_decode as jax_greedy
    from tpu_speech_torch.eval.wer import ctc_greedy_decode

    wavs, lens = wav_batch(seed, lens, n)
    apply = jit_apply(jmodel)
    jspecs, jlens = apply(variables, jnp.asarray(wavs), jnp.asarray(lens),
                          method=type(jmodel).featurize)
    want, want_lens = apply(variables, jspecs, jlens)
    with torch.no_grad():
        specs, spec_lens = port.featurize(torch.tensor(wavs), torch.tensor(lens))
        got, got_lens = port(specs, spec_lens)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert_valid_frames_close(got, want, want_lens, WAV_ATOL)
    assert ctc_greedy_decode(_np(got), got_lens.numpy(), port.blank_idx) == jax_greedy(
        np.asarray(want), np.asarray(want_lens), jmodel.blank_idx)


def test_forward_from_wavs_matches_jax(tiny):
    check_wav_path(*tiny)


def test_ctc_bpe_model_and_decode_match_jax(tiny, tmp_path):
    from tpu_speech.text.tokenizers import SubwordTokenizer as JaxSubword

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["<unk>", "▁the", "▁cat", "▁s", "at", "s"]), encoding="utf-8")
    tok, jtok = SubwordTokenizer(str(vocab)), JaxSubword(str(vocab))
    jmodel = jc.make_ctc_bpe_model(jtok, blocks=TINY.blocks, n_mels=12, decoder_filters=16)
    model = pc.make_ctc_bpe_model(tok, blocks=port_blocks(TINY.blocks), device="cpu",
                                  n_mels=12, decoder_filters=16)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
    assert model.blank_idx == jmodel.blank_idx == tok.vocab_size
    specs, lens = specs_batch(2, 2, 24, 12, [24, 16])
    variables = perturbed(jit_init(jmodel, specs, lens), 4)
    model.load_state_dict(enc_dec_ctc_from_jax(variables), strict=True)
    want, want_lens = jit_apply(jmodel)(variables, jnp.asarray(specs), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = model.eval()(torch.tensor(specs), torch.tensor(lens))
    want_texts = jc.decode_ctc_bpe(want, want_lens, jtok, jmodel.blank_idx)
    assert pc.decode_ctc_bpe(got, got_lens, tok, model.blank_idx) == want_texts
    assert pc.decode_ctc_bpe(np.asarray(want), np.asarray(want_lens), tok,
                             model.blank_idx) == want_texts


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.EncDecCTCModel(port_cfg(TINY))


# ---- the train step -----------------------------------------------------------

def ctc_batch(seed, b, t, f, spec_lens, n_classes, label_lens):
    specs, spec_lens = specs_batch(seed, b, t, f, spec_lens)
    r = np.random.default_rng(seed + 100)
    labels = r.integers(0, n_classes, size=(b, max(label_lens))).astype(np.int32)
    return {"specs": specs, "spec_lens": spec_lens, "labels": labels,
            "label_lens": np.asarray(label_lens, np.int32)}


def _to_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def check_train_steps(jmodel, variables, port, from_jax, batch, steps=3, lr=1e-3,
                      clip=1.0):
    """The first gradients (before the clip) within 1e-4 x max|g|, then
    ``steps`` steps of ``make_ctc_train_step`` in both packages (BatchNorm
    in train mode, dropout 0, the clip at ``clip``, AdamW with optax's
    weight decay 1e-4 and eps 1e-3: a bias followed by a train-mode
    BatchNorm has a true gradient of 0, whose ~1e-9 rounding noise Adam at
    eps 1e-8 would turn into steps of +-lr on either side): each loss within
    1e-5 relative, then every parameter and BatchNorm statistic within
    2e-5."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, bstats = variables["params"], variables["batch_stats"]
    tx = optax.adamw(lr, eps=1e-3)
    jstep = jc.make_ctc_train_step(jmodel, tx, grad_clip=clip)

    def loss_fn(p, bs, b):
        (lp, ol), _ = jmodel.apply({"params": p, "batch_stats": bs}, b["specs"],
                                   b["spec_lens"], train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_ctc_loss(lp, ol, b["labels"], b["label_lens"], jmodel.blank_idx)

    # one program for the gradients and the step (each compile is seconds)
    grads_and_step = jax.jit(lambda st, b, key: (
        jax.grad(loss_fn)(st.params, st.batch_stats, b), jstep(st, b, key)))
    jstate = JaxCTCState(jnp.zeros((), jnp.int32), params, bstats, tx.init(params))
    jgrads, (jstate, jm) = grads_and_step(jstate, jb, jax.random.PRNGKey(0))
    jgrads = from_jax({"params": jax.tree.map(np.asarray, jgrads), "batch_stats": bstats})
    losses = [float(jm["loss"])]
    for i in range(1, steps):
        _, (jstate, jm) = grads_and_step(jstate, jb, jax.random.PRNGKey(i))
        losses.append(float(jm["loss"]))
    probe = copy.deepcopy(port).train()
    tb = _to_torch(batch)
    lp, ol = probe(tb["specs"], tb["spec_lens"])
    ctc_loss(lp, ol, tb["labels"], tb["label_lens"], probe.blank_idx).backward()
    got = {n: _np(p.grad) for n, p in probe.named_parameters()}
    g_max = max(float(np.abs(jgrads[n].numpy()).max()) for n in got)
    for n in got:
        want = jgrads[n].numpy()
        bound = GRAD_RTOL * max(float(np.abs(want).max()), 1e-2 * g_max)
        np.testing.assert_allclose(got[n], want, rtol=0, atol=bound, err_msg=n)

    model = copy.deepcopy(port)
    state = pc.init_ctc_state(model, lambda ps: AdamW(ps, lr, eps=1e-3, weight_decay=1e-4))
    step = pc.make_ctc_train_step(model, grad_clip=clip)
    for i, want in enumerate(losses):
        m = step(state, tb)
        assert abs(float(m["loss"]) - want) <= STEP_LOSS_RTOL * abs(want), (i, m, want)
    assert state.step == steps and state.optimizer.count == steps
    final = from_jax({"params": jax.tree.map(np.asarray, jstate.params),
                      "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            want = final[k].numpy()
            np.testing.assert_allclose(_np(v), want, rtol=0,
                                       atol=PARAM_ATOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=k)


def test_train_steps_match_jax(tiny):
    jmodel, variables, port = tiny
    batch = ctc_batch(21, 2, 40, TINY.n_mels, [40, 32], TINY.num_classes, [6, 4])
    check_train_steps(jmodel, variables, port, enc_dec_ctc_from_jax, batch)
