"""PyTorch port, SPIRAL CTC finetuning against the JAX package on the CPU:
``ctc_loss`` (and what it gives for labels that cannot fit), the whole
``finetune_step`` at the tiny config (SGD gradients, frozen and unfrozen,
and two AdamW steps), the finetune runner's host-side masks, the
pretrained-encoder surgery from each checkpoint kind, and the CLI's finetune
train mode followed by its test mode.

Inputs come from numpy seeds. The JAX step runs on the CPU's XLA path at
full fp32 matmul precision; dither, dropout, layerdrop and spec masks are off
on both sides (their random bits cannot match across frameworks).
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_speech.compat import torch_spiral
from tpu_speech.data.wav import write_wav
from tpu_speech.models.spiral import ctc as jctc
from tpu_speech.text.tokenizers import CharTokenizer
from tpu_speech.train import optim as joptim
from tpu_speech.train.spiral_runner import SpiralFinetuneRunner as JaxFinetuneRunner
from tpu_speech.utils.config import AdamWParams
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.compat.jax_spiral import ctc_finetune_from_jax
from tpu_speech_torch.configs.spiral import (
    spiral_base_ctc_char,
    spiral_tiny_ctc_char,
    spiral_tiny_pretrain,
)
from tpu_speech_torch.models.spiral import ctc
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder
from tpu_speech_torch.ops import _build
from tpu_speech_torch.train import optim
from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
from tpu_speech_torch.train.spiral import batch_to_device
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner, build_model
from tests.test_torch_spiral_ctc import jax_ctc_model, jax_encoder_cfg

jax.config.update("jax_default_matmul_precision", "highest")

SR = 16000


def _np(t):
    return t.detach().cpu().numpy()


def _leaves(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], pre + (k,))
    else:
        yield pre, np.asarray(tree)


# ---- ctc_loss ----------------------------------------------------------------

def _ctc_case(rng, b, t, v, lmax, logit_lens, label_lens):
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = np.zeros((b, lmax), np.int32)
    for i, n in enumerate(label_lens):
        labels[i, :n] = rng.integers(0, v - 1, size=n)  # the blank is v - 1
    return log_probs, np.asarray(logit_lens, np.int32), labels, np.asarray(label_lens, np.int32)


@pytest.mark.parametrize("b,t,v,lmax,logit_lens,label_lens", [
    (3, 20, 6, 8, [20, 16, 12], [8, 5, 3]),
    (2, 37, 29, 12, [37, 9], [12, 1]),
    (4, 50, 10, 20, [50, 50, 31, 44], [20, 7, 12, 0]),
])
def test_ctc_loss_matches_jax(rng, b, t, v, lmax, logit_lens, label_lens):
    """Mean over the batch of optax's per-sequence NLL, with repeated
    labels, an empty label and varied lengths. Tolerance 1e-5 relative."""
    lp, ll, lab, lab_l = _ctc_case(rng, b, t, v, lmax, logit_lens, label_lens)
    ref = jctc.ctc_loss(*map(jnp.asarray, (lp, ll, lab, lab_l)), v - 1)
    got = ctc.ctc_loss(*map(torch.tensor, (lp, ll, lab, lab_l)), v - 1)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_ctc_loss_gradient_matches_jax(rng):
    lp, ll, lab, lab_l = _ctc_case(rng, 3, 24, 7, 9, [24, 18, 10], [9, 6, 2])
    ref = jax.grad(lambda x: jctc.ctc_loss(x, *map(jnp.asarray, (ll, lab, lab_l)), 6))(
        jnp.asarray(lp))
    x = torch.tensor(lp, requires_grad=True)
    ctc.ctc_loss(x, *map(torch.tensor, (ll, lab, lab_l)), 6).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


def test_ctc_loss_on_labels_that_cannot_fit_is_finite_and_zero(rng):
    """A sequence whose labels need more frames than it has: optax gives a
    large finite loss (its log_epsilon), torch's default an infinite one.
    The port gives 0 and a zero gradient for that sequence; the others keep
    their loss and gradient."""
    lp, ll, lab, lab_l = _ctc_case(rng, 2, 10, 6, 12, [10, 10], [12, 4])
    ref = jctc.ctc_loss(*map(jnp.asarray, (lp, ll, lab, lab_l)), 5)
    assert np.isfinite(float(ref)) and float(ref) > 1e3
    x = torch.tensor(lp, requires_grad=True)
    got = ctc.ctc_loss(x, *map(torch.tensor, (ll, lab, lab_l)), 5)
    got.backward()
    assert torch.isfinite(got) and torch.isfinite(x.grad).all()
    assert not x.grad[0].any()
    alone = ctc.ctc_loss(*map(torch.tensor, (lp[1:], ll[1:], lab[1:], lab_l[1:])), 5)
    np.testing.assert_allclose(float(got.detach()), float(alone) / 2, rtol=1e-6)


# ---- the step ----------------------------------------------------------------

def _tiny(layerdrop=0.0):
    """spiral_tiny_ctc_char with dither, every dropout and the spec masks off
    (the port's run config) and the equal JAX model and encoder config."""
    cfg = spiral_tiny_ctc_char()
    enc = cfg.model.encoder
    blocks = tuple(dataclasses.replace(b, transformer=dataclasses.replace(
        b.transformer, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        encoder_layerdrop=layerdrop)) for b in enc.blocks)
    cfg.model.encoder = dataclasses.replace(enc, blocks=blocks, dither=0.0)
    dec = cfg.model.decoder
    cfg.model.decoder = dataclasses.replace(dec, upsample_dropout=0.0, conv_layers=tuple(
        dataclasses.replace(c, dropout=0.0) for c in dec.conv_layers))
    return cfg, jax_ctc_model(cfg), jax_encoder_cfg(cfg.model.encoder)


@pytest.fixture(scope="module")
def jax_init():
    cfg, jmodel, jcfg = _tiny()
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)
    return cfg, jmodel, jcfg, jax.tree.map(np.asarray, variables["params"])


def _batch(seed=0):
    r = np.random.default_rng(seed)
    wavs = (r.standard_normal((2, SR)) * 0.1).astype(np.float32)
    lens = np.array([SR, 11000], np.int32)
    wavs[1, 11000:] = 0
    labels = np.zeros((2, 512), np.int32)
    label_lens = np.array([9, 5], np.int32)
    for i, n in enumerate(label_lens):
        labels[i, :n] = r.integers(0, 28, size=n)
    return {"wavs": wavs, "wav_lens": lens, "labels": labels, "label_lens": label_lens}


def _port_state(cfg, params, make_opt):
    model = build_model(cfg, 28)
    model.load_state_dict(ctc_finetune_from_jax(params, {}), strict=True)
    return make_finetune_state(model, make_opt)


def _port_tree(model):
    """The port's parameters as the JAX finetune tree."""
    (enc, _, _), (dec, _) = torch_spiral.convert_ctc_finetune(
        {k: _np(v) for k, v in model.state_dict().items()})
    return {"encoder": enc, "decoder": dec}


def _jax_sgd(jax_init, batch, frozen=False, **step_kw):
    """One JAX finetune step with optax.sgd(1.0) from the fixture's weights:
    (new params, metrics) as numpy."""
    _, jmodel, jcfg, params = jax_init
    tx = optax.sgd(1.0)
    jstate = jctc.CTCTrainState(jnp.zeros((), jnp.int32), params, {}, tx.init(params))
    jstep = jctc.make_finetune_step(jmodel, jcfg, tx, freeze_finetune_updates=1, **step_kw)
    jnew, jm = jstep(jstate, batch, jax.random.PRNGKey(3), iteration=0 if frozen else 1)
    return jax.device_get(jnew.params), jax.device_get(jm)


@pytest.fixture(scope="module")
def jax_sgd_step(jax_init):
    """The JAX fp32 unfrozen SGD(1) step on ``_batch()``, compiled once for
    the fp32 and the bf16 parity tests: (new params, metrics)."""
    return _jax_sgd(jax_init, _batch())


def _sgd_grads(old, new):
    """The gradient leaves of an SGD(1) step: old - new."""
    old, new = dict(_leaves(old)), dict(_leaves(new))
    assert old.keys() == new.keys()
    return {k: old[k] - new[k] for k in old}


@pytest.mark.parametrize("frozen", [True, False])
def test_finetune_step_gradients_match_jax_sgd(jax_init, jax_sgd_step, frozen):
    """optax.sgd(1.0) on both sides: the parameter delta is -grad. Loss
    within 1e-5 relative; each gradient tensor within 1e-4 x its max|g|,
    floored at 1e-4 x 1 % of the largest gradient anywhere (the key biases'
    true gradient is exactly 0: both sides see rounding noise there). A
    frozen step leaves the encoder exactly where it was on both sides."""
    cfg, jmodel, jcfg, params = jax_init
    batch = _batch()
    want_new, jm = _jax_sgd(jax_init, batch, frozen=True) if frozen else jax_sgd_step
    state = _port_state(cfg, params, lambda ps: torch.optim.SGD(ps, lr=1.0))
    before = dict(_build.LAUNCHES)
    m = finetune_step(state, batch_to_device(batch, "cpu"), DropoutRng.seeded(0, "cpu"),
                      freeze_encoder=frozen)
    assert _build.LAUNCHES == before  # the plain versions on the CPU
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert m["layers"] == 2
    got, want = _sgd_grads(params, _port_tree(state.model)), _sgd_grads(params, want_new)
    if frozen:
        for k in want:
            if k[0] == "encoder":
                assert not want[k].any() and not got[k].any(), "/".join(k)
    _assert_grads_close(got, want)


def _assert_grads_close(got, want, rtol=1e-4):
    """Each gradient leaf within rtol x its max|g|, floored at rtol x 1 % of
    the largest gradient anywhere."""
    assert got.keys() == want.keys()
    g_max = max(float(np.abs(g).max()) for g in want.values())
    for k, g_ref in want.items():
        bound = rtol * max(float(np.abs(g_ref).max()), 1e-2 * g_max)
        np.testing.assert_allclose(got[k], g_ref, atol=bound, rtol=0, err_msg="/".join(k))


def test_finetune_step_accum2_matches_jax_sgd(jax_init):
    """accum_steps=2, fp32, optax.sgd(1.0), unfrozen: the port's step on a
    list of two micro-batches against the JAX step on them stacked (its
    scan, one update per call): the averaged loss within 1e-5 and the
    averaged gradients within 1e-4 x max|g|, the single step's limits."""
    cfg, _, _, params = jax_init
    micro = [_batch(seed=s) for s in (3, 4)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *micro)
    want_new, jm = _jax_sgd(jax_init, stacked, accum_steps=2)
    state = _port_state(cfg, params, lambda ps: torch.optim.SGD(ps, lr=1.0))
    m = finetune_step(state, [batch_to_device(mb, "cpu") for mb in micro],
                      DropoutRng.seeded(0, "cpu"), accum_steps=2)
    assert state.step == 1 and m["layers"] == 4
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_grads_close(_sgd_grads(params, _port_tree(state.model)),
                        _sgd_grads(params, want_new))


def test_finetune_accum2_on_halves_equals_accum1_on_the_whole(jax_init):
    """Two micro-batches of 2 utterances at accum_steps=2 against one batch
    of the 4 at accum_steps=1, SGD(0.1) on both: the loss within 1e-6
    relative and every parameter within 2e-5 relative (+ 2e-7), the bounds
    of tests/test_distributed.py's accumulation test."""
    cfg, _, _, params = jax_init
    halves = [_batch(seed=s) for s in (5, 6)]
    whole = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
    out = []
    for batch, accum in ((whole, 1), (halves, 2)):
        state = _port_state(cfg, params, lambda ps: torch.optim.SGD(ps, lr=0.1))
        dev = batch_to_device(batch, "cpu") if accum == 1 else [
            batch_to_device(h, "cpu") for h in batch]
        m = finetune_step(state, dev, DropoutRng.seeded(0, "cpu"), accum_steps=accum)
        out.append((float(m["loss"]), dict(_leaves(_port_tree(state.model)))))
    (l1, p1), (l2, p2) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=2e-5, atol=2e-7, err_msg="/".join(k))


def test_finetune_step_bf16_within_the_jax_bf16_error(jax_init, jax_sgd_step, monkeypatch):
    """bf16=True against the JAX package's own bf16 step, unfrozen, on the
    batch and weights of the fp32 parity test. With L32 the JAX fp32 loss,
    Lj the JAX bf16 loss and Lp the port's: |Lp - L32| <= 2 |Lj - L32| +
    5e-3 |L32|; per gradient leaf (max|g32| at least 1 % of the largest) in
    L2 norm: ||gp - g32|| <= 2 ||gj - g32|| + 1e-2 ||g32||. The parameters
    and their gradients stay float32 (the masters), and the attention
    receives bf16."""
    from tpu_speech_torch.models.spiral import wav2vec

    cfg, _, _, params = jax_init
    want32, jm32 = jax_sgd_step
    want16, jm16 = _jax_sgd(jax_init, _batch(), bf16=True)
    seen = []
    attention = wav2vec.fused_qkv_self_attention

    def recording(qkv, *args):
        seen.append(qkv.dtype)
        return attention(qkv, *args)

    monkeypatch.setattr(wav2vec, "fused_qkv_self_attention", recording)
    state = _port_state(cfg, params, lambda ps: torch.optim.SGD(ps, lr=1.0))
    m = finetune_step(state, batch_to_device(_batch(), "cpu"), DropoutRng.seeded(0, "cpu"),
                      bf16=True)
    assert seen and set(seen) == {torch.bfloat16}
    assert m["loss"].dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in state.model.parameters())
    l32, lj, lp = float(jm32["loss"]), float(jm16["loss"]), float(m["loss"])
    assert abs(lp - l32) <= 2 * abs(lj - l32) + 5e-3 * abs(l32), (lp, lj, l32)
    g32, gj = _sgd_grads(params, want32), _sgd_grads(params, want16)
    gp = _sgd_grads(params, _port_tree(state.model))
    g_max = max(float(np.abs(g).max()) for g in g32.values())
    for k, g in g32.items():
        if np.abs(g).max() < 1e-2 * g_max:
            continue
        err_p, err_j = np.linalg.norm(gp[k] - g), np.linalg.norm(gj[k] - g)
        assert err_p <= 2 * err_j + 1e-2 * np.linalg.norm(g), ("/".join(k), err_p, err_j)


def test_bf16_accum_adamw_finetune_keeps_float32_masters_and_state(jax_init, monkeypatch):
    """Two bf16 finetune steps with AdamW, accumulating two micro-batches
    with time and channel masks, the first frozen: the parameters, their
    gradients and the optimizer's moments stay float32, the step count moves
    once per call, the loss is finite, and the frozen step moved the
    encoder by the decay alone. The masked specs stay bf16 up to the
    attention: the mask embedding takes the specs' dtype. (The JAX step
    fills with its float32 embedding, which promotes the bf16 specs, and so
    the network, to float32: ROADMAP Queue 3.)"""
    from tpu_speech.models.spiral import masking as jmasking
    from tpu_speech_torch.models.spiral import wav2vec

    promoted = jmasking.apply_mask(jnp.zeros((1, 4, 16), jnp.bfloat16), np.ones((1, 4), bool),
                                   None, np.asarray(jmasking.gaussian_mask_emb(16)))
    assert promoted.dtype == jnp.float32
    seen = []
    attention = wav2vec.fused_qkv_self_attention
    monkeypatch.setattr(wav2vec, "fused_qkv_self_attention",
                        lambda qkv, *a: seen.append(qkv.dtype) or attention(qkv, *a))
    cfg, _, _, params = jax_init
    state = _port_state(cfg, params, lambda ps: optim.AdamW(ps, 1e-3, weight_decay=0.1))
    enc0 = {k: v.clone() for k, v in state.model.encoder.state_dict().items()}
    for i in range(2):
        micro = []
        for j in range(2):
            batch = _batch(seed=20 + 2 * i + j)
            batch["time_mask"] = np.zeros((2, 112), bool)
            batch["time_mask"][:, 10:20] = True
            batch["chan_mask"] = np.zeros((2, 16), bool)
            batch["chan_mask"][:, 3] = True
            micro.append(batch_to_device(batch, "cpu"))
        m = finetune_step(state, micro, DropoutRng.seeded(i, "cpu"), freeze_encoder=i == 0,
                          bf16=True, accum_steps=2)
        assert torch.isfinite(m["loss"]) and m["loss"].dtype == torch.float32
        if i == 0:
            for k, v in state.model.encoder.state_dict().items():
                torch.testing.assert_close(v, enc0[k] * (1 - 1e-3 * 0.1), rtol=1e-6, atol=0,
                                           msg=k)
    assert state.step == 2 and state.optimizer.count == 2
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in state.model.parameters())
    moments = [v for st in state.optimizer.state.values() for v in st.values()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert seen and set(seen) == {torch.bfloat16}


def test_finetune_step_two_adamw_steps_match_jax(jax_init):
    """AdamW (lr 1e-3, weight decay 0.1, constant schedule) in both packages,
    step 0 frozen and step 1 not: the losses, then every parameter within
    2e-5. After the frozen step the encoder has moved by the decay alone,
    p * (1 - lr * wd) (1e-4 of p, far above fp32 rounding). eps is 1e-3:
    the key biases' true gradient is 0, and at eps 1e-6 Adam would turn
    their ~1e-6 rounding noise into steps of +-lr on either side."""
    cfg, jmodel, jcfg, params = jax_init
    ocfg = AdamWParams(lr=1e-3, eps=1e-3, betas=(0.9, 0.98), weight_decay=0.1, sched=None)
    tx = joptim.make_optimizer(ocfg, 100)
    jstate = jctc.CTCTrainState(jnp.zeros((), jnp.int32), params, {}, tx.init(params))
    jstep = jctc.make_finetune_step(jmodel, jcfg, tx, freeze_finetune_updates=1)
    state = _port_state(cfg, params, lambda ps: optim.make_optimizer(ocfg, ps, 100))
    enc0 = {k: v.clone() for k, v in state.model.encoder.state_dict().items()}
    for i in range(2):
        batch = _batch(seed=10 + i)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(i), iteration=i)
        m = finetune_step(state, batch_to_device(batch, "cpu"), DropoutRng.seeded(i, "cpu"),
                          freeze_encoder=i < 1)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert m["lr"] == pytest.approx(1e-3)
        if i == 0:
            for k, v in state.model.encoder.state_dict().items():
                torch.testing.assert_close(v, enc0[k] * (1 - 1e-3 * 0.1), rtol=1e-6, atol=0,
                                           msg=k)
    assert state.step == int(jstate.step) == 2
    got, want = dict(_leaves(_port_tree(state.model))), dict(_leaves(jax.device_get(jstate.params)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=0, err_msg="/".join(k))


def test_adamw_never_sees_nan_from_labels_that_cannot_fit(jax_init):
    """A batch row whose 100 labels cannot fit its 56 frames: the loss, every
    gradient and every parameter after the AdamW step stay finite."""
    cfg, _, _, params = jax_init
    batch = _batch()
    batch["label_lens"] = np.array([9, 100], np.int32)
    batch["labels"][1, :100] = 3
    state = _port_state(cfg, params, lambda ps: optim.AdamW(ps, 1e-3, weight_decay=0.1))
    m = finetune_step(state, batch_to_device(batch, "cpu"), DropoutRng.seeded(0, "cpu"))
    assert np.isfinite(float(m["loss"]))
    for p in state.model.parameters():
        assert torch.isfinite(p.grad).all() and torch.isfinite(p).all()


def test_layerdrop_skipped_layers_get_zero_gradients_and_decay():
    """Every layer dropped: the skipped layers' gradients are zeros and
    AdamW moves them by the weight decay alone, as optax does."""
    cfg, _, _ = _tiny(layerdrop=1.0)
    model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(0))
    state = make_finetune_state(model, lambda ps: optim.AdamW(ps, 1e-2, weight_decay=0.1))
    layer = model.encoder.feature_encoder.block_modules[2].layers[0]
    w0 = layer.fc1.weight.detach().clone()
    m = finetune_step(state, batch_to_device(_batch(), "cpu"), DropoutRng.seeded(0, "cpu"))
    assert m["layers"] == 0
    assert layer.fc1.weight.grad is not None and not layer.fc1.weight.grad.any()
    torch.testing.assert_close(layer.fc1.weight.detach(), w0 * (1 - 1e-2 * 0.1),
                               rtol=1e-6, atol=0)


def test_training_forward_needs_an_explicit_rng():
    cfg = spiral_tiny_ctc_char()  # decoder dropout 0.1
    model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(0)).train()
    specs, lens = torch.zeros(1, 32, 16), torch.tensor([32])
    with pytest.raises(ValueError, match="DropoutRng"):
        model(specs, lens)
    lp, _ = model(specs, lens, DropoutRng.seeded(0, "cpu"), freeze_encoder=True)
    assert lp.shape == (1, 16, 29) and torch.isfinite(lp).all()
    lp.sum().backward()  # a frozen encoder: no graph through it
    assert all(p.grad is None for p in model.encoder.parameters())
    assert model.decoder.decoder_layers[0].weight.grad is not None


# ---- the runner ----------------------------------------------------------------

def test_serving_runner_builds_nothing_of_training(tmp_path):
    """A runner that only serves builds no optimizer, generator or loader."""
    runner = SpiralFinetuneRunner(spiral_tiny_ctc_char(), str(tmp_path), CharTokenizer(),
                                  device="cpu")
    runner.infer(np.zeros((1, SR), np.float32), np.array([SR]))
    assert not {"state", "rng", "host_rng", "loader"} & set(vars(runner))
    assert not runner.model.training


def test_train_masks_equal_jax_from_one_seed(tmp_path):
    """The runner's spec masks (host generator default_rng(1)) against the
    JAX runner's _train_masks on the same generator, over two batches at the
    SPIRAL-base finetune mask settings."""
    cfg = spiral_tiny_ctc_char()
    base = spiral_base_ctc_char().model.encoder
    cfg.model.encoder = dataclasses.replace(
        cfg.model.encoder, mask_prob=base.mask_prob, mask_length=base.mask_length,
        mask_channel_prob=base.mask_channel_prob,
        mask_channel_length=base.mask_channel_length)
    runner = SpiralFinetuneRunner(cfg, str(tmp_path), CharTokenizer(), device="cpu")
    jself = types.SimpleNamespace(sample_rate=SR, enc_cfg=jax_encoder_cfg(cfg.model.encoder),
                                  host_rng=np.random.default_rng(1))
    for width, lens in ((SR, [SR, 9000, 4000]), (2 * SR, [32000, 31000, 20000])):
        got = runner._train_masks(width, np.array(lens))
        ref = JaxFinetuneRunner._train_masks(jself, width, np.array(lens))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (3, ((1 + width // 160 + 15) // 16) * 16)


def _pretrained(tmp_path):
    """A tiny pretraining model whose EMA teacher differs from the student,
    saved as the pretrain runner saves it (``st2vec.pt``)."""
    model = ST2VecEncoder(spiral_tiny_pretrain().model.encoder, pretraining=True)
    model.init_weights(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.teacher_parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.01)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "st2vec.pt")
    torch.save(sd, path)
    return sd, path


def _runner_from_pretrain(tmp_path, path, use_teacher):
    cfg = spiral_tiny_ctc_char()
    cfg.model.pretrain_chkpt_path = path
    cfg.model.use_teacher_encoder = use_teacher
    return SpiralFinetuneRunner(cfg, str(tmp_path / "ft"), CharTokenizer(), device="cpu")


@pytest.mark.parametrize("use_teacher", [False, True])
def test_load_pretrained_encoder_equals_jax(tmp_path, use_teacher):
    """st2vec.pt -> the port's encoder surgery against the JAX package's:
    convert_st2vec, then load_pretrained_encoder on a JAX finetune tree.
    The encoders are equal exactly."""
    sd, path = _pretrained(tmp_path)
    runner = _runner_from_pretrain(tmp_path, path, use_teacher)
    params, _, teacher = torch_spiral.convert_st2vec({k: _np(v) for k, v in sd.items()})
    _, jmodel, _ = _tiny()
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)
    ref = jctc.load_pretrained_encoder(jax.tree.map(np.asarray, variables["params"]),
                                       params, use_teacher, teacher)
    got = dict(_leaves(_port_tree(runner.model)["encoder"]))
    want = dict(_leaves(jax.device_get(ref["encoder"])))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    src = "target_feature_encoder." if use_teacher else "feature_encoder."
    other = "feature_encoder." if use_teacher else "target_feature_encoder."
    w = runner.model.encoder.feature_encoder.block_modules[0].conv.conv.weight
    torch.testing.assert_close(w, sd[src + "block_modules.0.conv.conv.weight"], rtol=0, atol=0)
    assert not torch.equal(w, sd[other + "block_modules.0.conv.conv.weight"])


@pytest.mark.parametrize("kind", ["lightning", "npz"])
def test_pretrained_encoder_from_other_checkpoint_kinds(tmp_path, kind):
    """A reference Lightning checkpoint (``st2vec_encoder.`` prefix under
    ``state_dict``) and JAX trees in an ``.npz`` load the same encoder as
    the port's st2vec.pt."""
    sd, path = _pretrained(tmp_path)
    if kind == "lightning":
        other = str(tmp_path / "ref.ckpt")
        torch.save({"state_dict": {f"st2vec_encoder.{k}": v for k, v in sd.items()},
                    "epoch": 3}, other)
    else:
        params, bstats, teacher = torch_spiral.convert_st2vec({k: _np(v) for k, v in sd.items()})
        other = str(tmp_path / "pre.npz")
        flat = {}
        for root, tree in (("params", params), ("batch_stats", bstats), ("teacher", teacher)):
            flat.update({"/".join((root,) + k): v for k, v in _leaves(tree)})
        np.savez(other, **flat)
    for use_teacher in (False, True):
        a = _runner_from_pretrain(tmp_path, path, use_teacher).model.encoder.state_dict()
        b = _runner_from_pretrain(tmp_path, other, use_teacher).model.encoder.state_dict()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    with pytest.raises(NotImplementedError, match="orbax"):
        _runner_from_pretrain(tmp_path, str(tmp_path), False)


def _corpus(root, n=6):
    r = np.random.default_rng(0)
    entries = []
    for i in range(n):
        d = 0.5 + 0.08 * i
        path = os.path.join(root, f"u{i}.wav")
        write_wav(path, (r.standard_normal(int(SR * d)) * 0.1).astype(np.float32), SR)
        entries.append({"audio_filepath": path, "duration": d, "text": "ab c" if i % 2 else "hi"})
    for name in ("librivox-train-clean-100.json", "librivox-dev-other.json"):
        with open(os.path.join(root, name), "w") as f:
            for e in entries:
                f.write(json.dumps(e) + "\n")


def test_cli_finetune_train_then_test_mode(tmp_path, capsys):
    """run_spiral --model_type ctc_finetune --run_mode train on the tiny
    config from a pretrained st2vec.pt (one frozen step, then two), with
    validation; then --run_mode test on the saved state_dict."""
    _corpus(str(tmp_path))
    sd, _ = _pretrained(tmp_path)
    before = dict(_build.LAUNCHES)
    out = run_spiral.main([
        "--model_type", "ctc_finetune", "--run_mode", "train",
        "--config_name", "spiral_tiny_ctc_char", "--manifest_dir", str(tmp_path),
        "--init_chkpt_dir", str(tmp_path), "--init_chkpt_file", "st2vec.pt",
        "--model_save_dir", str(tmp_path / "run"), "--device", "cpu",
        "--set", "trainer.max_steps=3", "--set", "model.train_ds.num_workers=1",
        "--set", "model.freeze_finetune_updates=1",
        "--set", "trainer.val_check_interval_epochs=1",
    ])
    assert _build.LAUNCHES == before
    assert out["iteration"] == 3 and [m["frozen"] for m in out["steps"]] == [True, False, False]
    assert all(np.isfinite(m["loss"]) and m["layers"] == 2 for m in out["steps"])
    assert 0.0 <= out["validation"]["cer"]
    printed = capsys.readouterr().out
    assert "Loaded the pretrained encoder" in printed and "Epoch 1: ctc loss =" in printed
    assert "Validation: WER =" in printed
    saved = torch.load(out["state_dict"], weights_only=True)
    torch_spiral.convert_ctc_finetune({k: _np(v) for k, v in saved.items()})  # strict
    # the frozen step moved the pretrained encoder by the decay alone, the
    # unfrozen steps by more
    w_pre = sd["feature_encoder.block_modules.0.conv.conv.weight"]
    assert not torch.equal(saved["encoder.feature_encoder.block_modules.0.conv.conv.weight"], w_pre)
    results = run_spiral.main([
        "--model_type", "ctc_finetune", "--run_mode", "test",
        "--config_name", "spiral_tiny_ctc_char",
        "--test_manifest", str(tmp_path / "librivox-dev-other.json"),
        "--model_save_dir", str(tmp_path / "test"), "--device", "cpu",
        "--init_chkpt_dir", str(tmp_path / "run"), "--init_chkpt_file", "ctc_finetune.pt",
    ])
    assert results["n"] == 6 and "TEST: WER =" in capsys.readouterr().out


def _recording_runner(tmp_path, monkeypatch, accum, n_utts=6):
    """A tiny finetune runner (batch 2, accum ``accum``, the first update
    frozen) over ``n_utts`` utterances whose ``finetune_step`` records its
    arguments instead of running."""
    from tpu_speech_torch.train import spiral_runner

    _corpus(str(tmp_path), n=n_utts)
    cfg = spiral_tiny_ctc_char()
    cfg.trainer.accumulate_grad_batches = accum
    cfg.model.freeze_finetune_updates = 1
    cfg.model.train_ds.manifest_filepath = str(tmp_path / "librivox-train-clean-100.json")
    cfg.model.train_ds.num_workers = 1
    calls = []

    def step(state, batch, rng, freeze_encoder=False, bf16=False, accum_steps=1):
        calls.append(dict(batch=batch, frozen=freeze_encoder, bf16=bf16, accum=accum_steps))
        return {"loss": torch.tensor(1.0)}

    monkeypatch.setattr(spiral_runner, "finetune_step", step)
    runner = SpiralFinetuneRunner(cfg, str(tmp_path / "run"), CharTokenizer(), device="cpu")
    return runner, calls


def test_finetune_runner_updates_once_per_accum_batches_and_carries_leftovers(
        tmp_path, monkeypatch):
    """accum 2 over 3 batches an epoch: epoch 1 makes one update and keeps
    one micro-batch, epoch 2 makes two more from it and its own three; each
    update gets a list of two micro-batches, the freeze gate is decided once
    per update from the update counter, and bf16 and accum reach the step."""
    runner, calls = _recording_runner(tmp_path, monkeypatch, accum=2)
    runner.bf16 = True
    assert len(runner.loader) == 3
    runner.train_epoch(1)
    assert runner.iteration == 1 and len(calls) == 1 and len(runner._micro) == 1
    left = runner._micro[0]
    runner.train_epoch(2)
    assert runner.iteration == 3 and len(calls) == 3 and not runner._micro
    assert calls[1]["batch"][0] is left
    assert [c["frozen"] for c in calls] == [True, False, False]
    assert all(c["accum"] == 2 and c["bf16"] and isinstance(c["batch"], list)
               and len(c["batch"]) == 2 for c in calls)
    assert [h["frozen"] for h in runner.history] == [True, False, False]


@pytest.mark.parametrize("accum", [1, 3])
def test_finetune_runner_lr_scale_includes_accumulation(tmp_path, monkeypatch, accum):
    """The finetune runner rescales the lr by data_parallel x accum /
    expected_gpu_num, as the JAX runner does (spiral_runner.py:726)."""
    from tpu_speech_torch.train import spiral_runner

    scales = []
    make = spiral_runner.make_optimizer

    def recording(optim_cfg, params, total_steps, lr_scale=1.0):
        scales.append(lr_scale)
        return make(optim_cfg, params, total_steps, lr_scale)

    monkeypatch.setattr(spiral_runner, "make_optimizer", recording)
    cfg = spiral_tiny_ctc_char()
    cfg.model.expected_gpu_num = 4
    cfg.trainer.accumulate_grad_batches = accum
    runner = SpiralFinetuneRunner(cfg, str(tmp_path), CharTokenizer(), device="cpu")
    runner.state  # noqa: B018 (built at first use)
    assert scales == [accum / 4]


def test_cli_finetune_runs_bf16_with_accumulation(tmp_path):
    """run_spiral --model_type ctc_finetune with --set model.precision=bf16
    --set trainer.accumulate_grad_batches=2 on the tiny config: two updates
    of two micro-batches each (the second epoch starts from the first's
    leftover), finite losses, the frozen first update, and a saved
    float32 state_dict."""
    _corpus(str(tmp_path))
    _pretrained(tmp_path)
    out = run_spiral.main([
        "--model_type", "ctc_finetune", "--run_mode", "train",
        "--config_name", "spiral_tiny_ctc_char", "--manifest_dir", str(tmp_path),
        "--init_chkpt_dir", str(tmp_path), "--init_chkpt_file", "st2vec.pt",
        "--model_save_dir", str(tmp_path / "run"), "--device", "cpu",
        "--set", "trainer.max_steps=2", "--set", "model.train_ds.num_workers=1",
        "--set", "model.freeze_finetune_updates=1",
        "--set", "model.precision=bf16", "--set", "trainer.accumulate_grad_batches=2",
        "--set", "trainer.max_epochs=2",
    ])
    assert out["iteration"] == 2 and [m["frozen"] for m in out["steps"]] == [True, False]
    assert all(np.isfinite(m["loss"]) and m["layers"] == 4 for m in out["steps"])
    saved = torch.load(out["state_dict"], weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved.values() if v.is_floating_point())
