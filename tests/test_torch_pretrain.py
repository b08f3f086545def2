"""PyTorch port, SPIRAL pretraining against the JAX package on the CPU: the
BatchNorm train semantics, the host-side twins (masks, batch augmentation,
int16 wire), AdamW and the schedules against optax, the teacher shift,
negatives and InfoNCE, the weight converter, layerdrop, the whole
``pretrain_step`` at the tiny config (SGD gradients and two AdamW steps),
the runners' device rule and the CLI's train mode.

Inputs come from numpy seeds. The JAX step runs on the CPU's XLA path at
full fp32 matmul precision; dropout and dither are off on both sides (their
random bits cannot match across frameworks), and the port takes the
negative indices JAX draws.
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

from tpu_speech.compat import torch_spiral
from tpu_speech.data.wav import write_wav
from tpu_speech.models.spiral import encoder as jenc
from tpu_speech.models.spiral import masking as jmasking
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.text.tokenizers import CharTokenizer
from tpu_speech.train import optim as joptim
from tpu_speech.train import schedules as jschedules
from tpu_speech.train import spiral as jspiral
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.compat.jax_spiral import st2vec_from_jax
from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char, spiral_tiny_pretrain
from tpu_speech_torch.models.spiral import masking
from tpu_speech_torch.models.spiral import st2vec
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.encoder import Projector
from tpu_speech_torch.ops import _build
from tpu_speech_torch.train import optim, schedules
from tpu_speech_torch.train import spiral as tspiral
from tpu_speech_torch.train.spiral_runner import (
    SpiralFinetuneRunner,
    SpiralPretrainRunner,
)
from tests.test_torch_spiral_ctc import jax_encoder_cfg

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


# ---- BatchNorm -------------------------------------------------------------

def test_batchnorm_train_matches_flax(rng):
    """One train-mode forward of the predictor (conv -> BN -> relu ->
    output_proj) in both packages: the outputs and the updated batch_stats
    (flax: biased batch variance, momentum 0.99). Tolerance 1e-6."""
    cfg = spiral_tiny_pretrain().model.encoder
    port = Projector(16, cfg.predictor_convs, 16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        bn = port.conv_layers[0].norm
        bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    sd = {f"p.{k}": v for k, v in port.state_dict().items()}
    params, stats, used = {}, {}, set()
    torch_spiral._convert_projector(sd, used, "p", params, stats)
    assert used == set(sd)
    x = rng.standard_normal((2, 20, 16)).astype(np.float32)
    lens = np.array([20, 13], np.int32)
    jmod = jenc.Projector(conv_layers=tuple(
        jenc.ConvLayerCfg(**dataclasses.asdict(c)) for c in cfg.predictor_convs),
        output_dim=16)
    ref, new_state = jmod.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), jnp.asarray(lens), train=True,
                                mutable=["batch_stats"])
    port.train()
    out = port(torch.tensor(x), torch.tensor(lens))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6, rtol=0)
    want = new_state["batch_stats"]["conv0"]["norm"]
    np.testing.assert_allclose(_np(bn.running_mean), np.asarray(want["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(bn.running_var), np.asarray(want["var"]), atol=1e-6, rtol=0)


# ---- host-side twins -------------------------------------------------------

@pytest.mark.parametrize("mask_type,no_overlap", [
    ("static", False), ("uniform", False), ("normal", True), ("poisson", True)])
def test_compute_mask_indices_equals_jax(mask_type, no_overlap):
    kw = dict(mask_type=mask_type, mask_other=2.0, min_masks=1,
              no_overlap=no_overlap, min_space=1, shrink_to_batch_min=True)
    lens = np.array([90, 64, 77])
    got = masking.compute_mask_indices((3, 90), lens, 0.4, 6,
                                       rng=np.random.default_rng(5), **kw)
    ref = jmasking.compute_mask_indices((3, 90), lens, 0.4, 6,
                                        rng=np.random.default_rng(5), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_host_augment_batch_and_wire_equal_jax(rng):
    """One seed -> equal student masks, teacher shifts and int16 wire arrays."""
    cfg = spiral_tiny_pretrain().model.encoder
    jcfg = jax_encoder_cfg(cfg)
    wavs = (rng.standard_normal((3, SR)) * 0.2).astype(np.float32)
    p_wavs = wavs + 0.01
    lens = np.array([SR, 12000, 7001], np.int32)
    got = tspiral.host_augment_batch(cfg, wavs, lens, p_wavs, lens, 112,
                                     np.random.default_rng(3), np.random.default_rng(4))
    ref = jspiral.host_augment_batch(jcfg, wavs, lens, p_wavs, lens, 112,
                                     np.random.default_rng(3), np.random.default_rng(4))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    got_w, ref_w = tspiral.quantize_wire_int16(got), jspiral.quantize_wire_int16(ref)
    for k in ("wavs", "p_wavs"):
        assert got_w[k].dtype == np.int16
        np.testing.assert_array_equal(got_w[k], ref_w[k])


def test_apply_mask_matches_jax(rng):
    specs = rng.standard_normal((2, 32, 16)).astype(np.float32)
    tm, cm = masking.make_student_masks(2, 32, 16, np.array([32, 24]),
                                        rng=np.random.default_rng(0))
    emb = masking.gaussian_mask_emb(16)
    np.testing.assert_array_equal(emb, jmasking.gaussian_mask_emb(16))
    ref = jmasking.apply_mask(jnp.asarray(specs), jnp.asarray(tm), jnp.asarray(cm),
                              jnp.asarray(emb))
    out = masking.apply_mask(torch.tensor(specs), torch.tensor(tm), torch.tensor(cm),
                             torch.tensor(emb))
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


# ---- optimizer and schedules -----------------------------------------------

def _optim_cfg(name):
    from tpu_speech.utils.config import AdamWParams, SchedParams

    if name == "PolynomialHoldDecayAnnealing":
        sched = SchedParams(name=name, warmup_ratio=0.1, hold_ratio=0.2,
                            max_steps=20, min_lr=1e-4)
    else:
        sched = SchedParams(name=name, warmup_steps=2, max_steps=6, min_lr=1e-4)
    return AdamWParams(lr=3e-2, eps=1e-6, betas=(0.9, 0.98), weight_decay=0.01,
                       sched=sched)


@pytest.mark.parametrize("name", ["CosineAnnealing", "PolynomialHoldDecayAnnealing"])
def test_schedules_match_jax(name):
    ocfg = _optim_cfg(name)
    ours = optim.make_schedule(ocfg, 100, lr_scale=0.5)
    theirs = joptim.make_schedule(ocfg, 100, lr_scale=0.5)
    for count in range(0, 25):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6, atol=0)


def test_schedule_functions_match_jax_directly():
    for ours, theirs in (
        (schedules.warmup_cosine(1e-3, 0, 10, 0.0), jschedules.warmup_cosine(1e-3, 0, 10, 0.0)),
        (schedules.polynomial_hold(1e-3, 3, 12, 2, power=2.0, min_lr=1e-5),
         jschedules.polynomial_hold(1e-3, 3, 12, 2, power=2.0, min_lr=1e-5)),
    ):
        for count in range(15):
            np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["CosineAnnealing", "PolynomialHoldDecayAnnealing"])
def test_adamw_matches_optax_over_five_steps(rng, name):
    """make_optimizer from one optim config in both packages, 5 updates
    across the warmup edge on the same gradients. Tolerance 1e-6."""
    ocfg = _optim_cfg(name)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    tx = joptim.make_optimizer(ocfg, 100)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.tensor(p) for p in p0]
    opt = optim.make_optimizer(ocfg, tp, 100)
    assert isinstance(opt, optim.AdamW)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)


def test_global_norm_clip_matches_the_jax_step(rng):
    g = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in ((3, 4), (7,))]
    ref = [x.numpy().copy() for x in g]
    norm = np.sqrt(sum((x * x).sum() for x in ref))
    scale = min(1.0, 0.5 / (norm + 1e-6))
    got = optim.clip_by_global_norm(g, 0.5)
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    for a, b in zip(g, ref):
        np.testing.assert_allclose(a.numpy(), b * scale, rtol=1e-6)
    assert optim.clip_by_global_norm(g, None) is None


# ---- teacher shift, negatives, loss, EMA ------------------------------------

@pytest.mark.parametrize("k,r", [(0, 0), (1, 2), (2, 1)])
def test_teacher_shift_matches_jax(rng, k, r):
    specs = rng.standard_normal((2, 32, 4)).astype(np.float32)
    lens = np.array([32, 21], np.int32)
    emb = rng.standard_normal(4).astype(np.float32)
    ref, ref_lens = jst2vec.teacher_shift(jnp.asarray(specs), jnp.asarray(lens),
                                          jnp.int32(k), jnp.int32(r), 8, 2, jnp.asarray(emb))
    out, out_lens = st2vec.teacher_shift(torch.tensor(specs), torch.tensor(lens), k, r, 8, 2,
                                         torch.tensor(emb))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(out_lens), np.asarray(ref_lens))


def _jax_raw_negative_indices(key, feat_lens, t, n):
    """The draw inside ``sample_negatives:229-230``."""
    high = jnp.maximum(jnp.asarray(feat_lens) - 1, 1)[:, None, None]
    return np.asarray(jax.random.randint(key, (len(feat_lens), t, n), 0, high))


def test_negatives_from_jax_indices_match_sample_negatives(rng):
    feats = rng.standard_normal((2, 10, 4)).astype(np.float32)
    lens = np.array([10, 6], np.int32)
    key = jax.random.PRNGKey(3)
    ref = jst2vec.sample_negatives(key, jnp.asarray(feats), jnp.asarray(lens), 8)
    idx = st2vec.exclude_self(torch.tensor(_jax_raw_negative_indices(key, lens, 10, 8)))
    out = st2vec.gather_negatives(torch.tensor(feats), idx)
    assert out.shape == (8, 2, 10, 4)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


def test_drawn_negatives_stay_in_the_utterance_and_skip_self():
    lens = torch.tensor([10, 6, 1])
    idx = st2vec.draw_negative_indices(lens, 10, 50, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 10, 50)
    pos = torch.arange(10)[None, :, None]
    for b, n in enumerate(lens.tolist()):
        valid = idx[b, :n]
        assert (valid >= 0).all() and (valid < max(n, 2)).all()
        if n > 1:
            assert (valid != pos[0, :n]).all()


def test_contrastive_loss_matches_jax(rng):
    b, t, d, n = 2, 6, 8, 4
    logits = rng.standard_normal((b, t, d)).astype(np.float32)
    targets = rng.standard_normal((b, t, d)).astype(np.float32)
    negs = rng.standard_normal((n, b, t, d)).astype(np.float32)
    negs[1, 0, 2] = targets[0, 2]  # a negative equal to the positive
    valid = np.ones((b, t), np.float32)
    valid[1, 4:] = 0
    ref = jst2vec.contrastive_loss(*map(jnp.asarray, (logits, targets, negs, valid)), 0.3)
    out = st2vec.contrastive_loss(*map(torch.tensor, (logits, targets, negs, valid)), 0.3)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(float(a), float(r), atol=1e-6, rtol=1e-6)


def test_momentum_schedule_matches_jax():
    for step in (0, 1, 50, 99, 100, 150):
        ref = jst2vec.momentum_schedule(jnp.int32(step), 0.995, 1.0, 100)
        assert st2vec.momentum_schedule(step, 0.995, 1.0, 100) == pytest.approx(
            float(ref), abs=1e-7)


# ---- the model and the converter --------------------------------------------

def _tiny(attention_dropout=0.0, layerdrop=0.0):
    """spiral_tiny_pretrain with dither off and the given transformer
    dropout/layerdrop: the port's config and the equal JAX one."""
    cfg = spiral_tiny_pretrain()
    enc = cfg.model.encoder
    blocks = tuple(dataclasses.replace(b, transformer=dataclasses.replace(
        b.transformer, attention_dropout=attention_dropout,
        encoder_layerdrop=layerdrop)) for b in enc.blocks)
    cfg.model.encoder = dataclasses.replace(enc, blocks=blocks, dither=0.0)
    return cfg, jax_encoder_cfg(cfg.model.encoder)


@pytest.fixture(scope="module")
def jax_init():
    cfg, jcfg = _tiny()
    jmodel = jst2vec.ST2VecEncoder(jcfg)
    state = jspiral.init_spiral_state(jmodel, jax.random.PRNGKey(0), (2, 112, 16),
                                      optax.sgd(1.0))
    params, bstats, teacher = (jax.tree.map(np.asarray, t) for t in
                               (state.params, state.batch_stats, state.teacher))
    return cfg, jcfg, jmodel, params, bstats, teacher


def test_st2vec_weight_round_trip_is_exact(jax_init):
    """JAX trees -> st2vec_from_jax -> the port loads strictly -> the JAX
    package's convert_st2vec gives the trees back exactly."""
    cfg, _, _, params, bstats, teacher = jax_init
    sd = st2vec_from_jax(params, bstats, teacher)
    model = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.load_state_dict(sd, strict=True)
    back = torch_spiral.convert_st2vec({k: _np(v) for k, v in model.state_dict().items()})
    for got, want in zip(back, (params, bstats, teacher)):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    with pytest.raises(ValueError, match="unconsumed"):
        st2vec_from_jax({**params, "stray": {"kernel": np.zeros(2)}}, bstats, teacher)


def test_teacher_parameters_are_frozen_and_outside_the_optimizer():
    cfg, _ = _tiny()
    model = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.init_weights(torch.Generator().manual_seed(0))
    teacher = {id(p) for p in model.teacher_parameters()}
    assert all(not p.requires_grad for p in model.teacher_parameters())
    assert not teacher & {id(p) for p in model.student_parameters()}
    for (_, t), (_, s) in zip(model.target_feature_encoder.state_dict().items(),
                              model.feature_encoder.state_dict().items()):
        torch.testing.assert_close(t, s, rtol=0, atol=0)
    # the CTC encoder has no pretraining modules
    assert set(st2vec.ST2VecEncoder(cfg.model.encoder).state_dict()) == {
        k for k in model.state_dict() if k.startswith("feature_encoder.")}


# ---- the whole step ---------------------------------------------------------

def _batch(jcfg, seed=0):
    r = np.random.default_rng(seed)
    wavs = (r.standard_normal((2, SR)) * 0.1).astype(np.float32)
    lens = np.array([SR, 12000], np.int32)
    wavs[1, 12000:] = 0
    return jspiral.host_augment_batch(jcfg, wavs, lens, wavs * 0.9 + 0.01, lens, 112,
                                      np.random.default_rng(seed + 1))


def _student_feat_lens(wav_lens):
    lens = np.ceil(np.asarray(wav_lens) / 160).astype(np.int64)
    for _ in range(3):  # the three stride-2 convs of the tiny encoder
        lens = (lens + 1) // 2
    return lens


def _port_state(cfg, params, bstats, teacher, make_opt):
    model = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.load_state_dict(st2vec_from_jax(params, bstats, teacher), strict=True)
    return tspiral.make_pretrain_state(model, make_opt)


def _port_step(state, jcfg, batch, key):
    neg = st2vec.exclude_self(torch.tensor(_jax_raw_negative_indices(
        jax.random.fold_in(key, 3), _student_feat_lens(batch["p_wav_lens"]), 14,
        jcfg.n_negatives)))
    return tspiral.pretrain_step(state, tspiral.batch_to_device(batch, "cpu"),
                                 DropoutRng.seeded(0, "cpu"), neg_idx=neg)


def _student_tree(model):
    """The port's student params, batch stats and teacher as JAX trees."""
    sd = {k: _np(v) for k, v in model.state_dict().items()}
    return torch_spiral.convert_st2vec(sd)


def _jax_sgd(jax_init, batch, key, **step_kw):
    """One JAX step with optax.sgd(1.0) from the fixture's weights: (new
    params, metrics) as numpy."""
    _, jcfg, jmodel, params, bstats, teacher = jax_init
    jstate = jspiral.SpiralTrainState(jnp.zeros((), jnp.int32), params, bstats, teacher,
                                      optax.sgd(1.0).init(params))
    jnew, jm = jspiral.make_pretrain_step(jmodel, jcfg, optax.sgd(1.0), **step_kw)(
        jstate, batch, key)
    return jax.device_get((jnew.params, jnew.batch_stats)), jax.device_get(jm)


@pytest.fixture(scope="module")
def jax_sgd_step(jax_init):
    """The JAX fp32 SGD(1) step on ``_batch`` with key 7, compiled once for
    the fp32 and the bf16 parity tests: (batch, key, (params, batch_stats),
    metrics)."""
    batch, key = _batch(jax_init[1]), jax.random.PRNGKey(7)
    return (batch, key) + _jax_sgd(jax_init, batch, key)


def _sgd_grads(old, new):
    """The gradient leaves of an SGD(1) step: old - new."""
    old, new = dict(_leaves(old)), dict(_leaves(new))
    assert old.keys() == new.keys()
    return {k: old[k] - new[k] for k in old}


def test_pretrain_step_gradients_match_jax_sgd(jax_init, jax_sgd_step):
    """optax.sgd(1.0) on both sides: the parameter delta is -grad. Loss
    within 1e-5 relative; each gradient tensor within 1e-4 x its max|g|,
    floored at 1e-4 x 1 % of the largest gradient anywhere: the key bias has
    an exactly zero gradient (the softmax ignores a per-row shift), so both
    sides see rounding noise there (the towers' CPU bound is PARITY.md's
    5e-4). Measured: about 1e-5 x max|g| per tensor."""
    cfg, jcfg, jmodel, params, bstats, teacher = jax_init
    batch, key, (want_new, _), jm = jax_sgd_step
    state = _port_state(cfg, params, bstats, teacher, lambda ps: torch.optim.SGD(ps, lr=1.0))
    before_launches = dict(_build.LAUNCHES)
    m = _port_step(state, jcfg, batch, key)
    assert _build.LAUNCHES == before_launches  # the plain versions on the CPU
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    _assert_grads_close(_sgd_grads(params, _student_tree(state.model)[0]),
                        _sgd_grads(params, want_new))


def _assert_grads_close(got, want, rtol=1e-4):
    """Each gradient leaf within rtol x its max|g|, floored at rtol x 1 %
    of the largest gradient anywhere."""
    assert got.keys() == want.keys()
    g_max = max(float(np.abs(g).max()) for g in want.values())
    for k, g_ref in want.items():
        bound = rtol * max(float(np.abs(g_ref).max()), 1e-2 * g_max)
        np.testing.assert_allclose(got[k], g_ref, atol=bound, rtol=0, err_msg="/".join(k))


def test_pretrain_step_accum2_matches_jax_sgd(jax_init):
    """accum_steps=2, fp32, optax.sgd(1.0): the port's step on a list of two
    micro-batches against the JAX step on them stacked (its scan, one update
    per call). The negatives of micro-batch i come from JAX's key
    fold_in(fold_in(key, i), 3). The averaged loss and accuracy, the
    averaged gradients and the BatchNorm statistics carried through both
    micro-batches, at the single step's limits (loss 1e-5, gradients 1e-4 x
    max|g|; statistics 1e-5)."""
    cfg, jcfg, _, params, bstats, teacher = jax_init
    micro = [_batch(jcfg, seed=s) for s in (3, 4)]
    key = jax.random.PRNGKey(11)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *micro)
    (want_new, want_stats), jm = _jax_sgd(jax_init, stacked, key, accum_steps=2)
    state = _port_state(cfg, params, bstats, teacher, lambda ps: torch.optim.SGD(ps, lr=1.0))
    negs = [st2vec.exclude_self(torch.tensor(_jax_raw_negative_indices(
        jax.random.fold_in(jax.random.fold_in(key, i), 3),
        _student_feat_lens(mb["p_wav_lens"]), 14, jcfg.n_negatives)))
        for i, mb in enumerate(micro)]
    m = tspiral.pretrain_step(state, [tspiral.batch_to_device(mb, "cpu") for mb in micro],
                              DropoutRng.seeded(0, "cpu"), accum_steps=2, neg_idx=negs)
    assert state.step == 1 and m["student_layers"] == m["teacher_layers"] == 4
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    got_params, got_stats, _ = _student_tree(state.model)
    _assert_grads_close(_sgd_grads(params, got_params), _sgd_grads(params, want_new))
    got_stats, want_stats = dict(_leaves(got_stats)), dict(_leaves(want_stats))
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], atol=1e-5, rtol=0,
                                   err_msg="/".join(k))


def test_pretrain_step_bf16_within_the_jax_bf16_error(jax_init, jax_sgd_step, monkeypatch):
    """bf16=True against the JAX package's own bf16 step, on the batch and
    weights of the fp32 parity test. With L32 the JAX fp32 loss, Lj the JAX
    bf16 loss and Lp the port's: |Lp - L32| <= 2 |Lj - L32| + 5e-3 |L32|;
    per gradient leaf (max|g32| at least 1 % of the largest) in L2 norm:
    ||gp - g32|| <= 2 ||gj - g32|| + 1e-2 ||g32||. The parameters and their
    gradients stay float32 (the masters), and the attention receives
    bf16."""
    from tpu_speech_torch.models.spiral import wav2vec

    cfg, jcfg, _, params, bstats, teacher = jax_init
    batch, key, (want32, _), jm32 = jax_sgd_step
    (want16, _), jm16 = _jax_sgd(jax_init, batch, key, bf16=True)
    seen = []
    attention = wav2vec.fused_qkv_self_attention

    def recording(qkv, *args):
        seen.append(qkv.dtype)
        return attention(qkv, *args)

    monkeypatch.setattr(wav2vec, "fused_qkv_self_attention", recording)
    state = _port_state(cfg, params, bstats, teacher, lambda ps: torch.optim.SGD(ps, lr=1.0))
    neg = st2vec.exclude_self(torch.tensor(_jax_raw_negative_indices(
        jax.random.fold_in(key, 3), _student_feat_lens(batch["p_wav_lens"]), 14,
        jcfg.n_negatives)))
    m = tspiral.pretrain_step(state, tspiral.batch_to_device(batch, "cpu"),
                              DropoutRng.seeded(0, "cpu"), bf16=True, neg_idx=neg)
    assert seen and set(seen) == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in state.model.student_parameters())
    l32, lj, lp = float(jm32["loss"]), float(jm16["loss"]), float(m["loss"])
    assert abs(lp - l32) <= 2 * abs(lj - l32) + 5e-3 * abs(l32), (lp, lj, l32)
    g32, gj = _sgd_grads(params, want32), _sgd_grads(params, want16)
    gp = _sgd_grads(params, _student_tree(state.model)[0])
    g_max = max(float(np.abs(g).max()) for g in g32.values())
    for k, g in g32.items():
        if np.abs(g).max() < 1e-2 * g_max:
            continue
        err_p, err_j = np.linalg.norm(gp[k] - g), np.linalg.norm(gj[k] - g)
        assert err_p <= 2 * err_j + 1e-2 * np.linalg.norm(g), ("/".join(k), err_p, err_j)


def test_batchnorm_bf16_matches_flax(rng):
    """FlaxBatchNorm1d on bf16 input with bf16 scale and bias against flax's
    BatchNorm (0.12: statistics and affine in float32, force_float32_
    reductions) on the same values: the bf16 output within one bf16 step
    (2**-7 relative) and the float32 running statistics within 1e-6."""
    import flax.linen as fnn

    from tpu_speech_torch.models.spiral.conv_layers import FlaxBatchNorm1d

    c = 12
    x = (rng.standard_normal((3, 17, c)) * 2 + 0.5).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, c)).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    mean0 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    xb, sb, bb = (torch.tensor(a).bfloat16() for a in (x, scale, bias))
    jx, js, jb = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (xb, sb, bb))
    ref, new = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3).apply(
        {"params": {"scale": js, "bias": jb},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}},
        jx, mutable=["batch_stats"])
    bn = FlaxBatchNorm1d(c, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor(mean0))
        bn.running_var.copy_(torch.tensor(var0))
    out = torch.func.functional_call(bn, {"weight": sb, "bias": bb}, (xb.transpose(1, 2),))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(out.transpose(1, 2).float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["batch_stats"]["var"]),
                               atol=1e-6, rtol=0)


def test_bf16_adamw_step_keeps_float32_masters_and_state():
    """Two bf16 steps with the port's AdamW, accumulating two micro-batches:
    the parameters, their gradients and the optimizer's moments stay
    float32, the step count moves once per call, the loss is finite."""
    cfg, jcfg = _tiny()
    model = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.init_weights(torch.Generator().manual_seed(0))
    state = tspiral.make_pretrain_state(model, lambda ps: optim.AdamW(ps, 1e-3))
    for i in range(2):
        micro = [tspiral.batch_to_device(_batch(jcfg, seed=2 * i + j), "cpu") for j in (0, 1)]
        m = tspiral.pretrain_step(state, micro, DropoutRng.seeded(i, "cpu"), bf16=True,
                                  accum_steps=2)
        assert torch.isfinite(m["loss"]) and m["loss"].dtype == torch.float32
    assert state.step == 2 and state.optimizer.count == 2
    assert all(p.dtype == torch.float32 for p in model.parameters())
    moments = [v for st in state.optimizer.state.values() for v in st.values()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    with pytest.raises(ValueError, match="micro-batches"):
        tspiral.pretrain_step(state, micro[:1], DropoutRng.seeded(0, "cpu"), accum_steps=2)


def test_pretrain_step_two_adamw_steps_match_jax(jax_init):
    """The config's AdamW and cosine schedule (lr scale 1), two steps: loss,
    accuracy and momentum per step, then the parameters, the EMA teacher and
    the BatchNorm statistics. Tolerances: loss 1e-5 relative; params,
    teacher and batch_stats 2e-5 absolute (AdamW normalizes the gradient,
    so a 1e-6 gradient difference can move an element by up to lr)."""
    cfg, jcfg, jmodel, params, bstats, teacher = jax_init
    tx = joptim.make_optimizer(cfg.model.optim, 100)
    jstate = jspiral.SpiralTrainState(jnp.zeros((), jnp.int32), params, bstats, teacher,
                                      tx.init(params))
    jstep = jspiral.make_pretrain_step(jmodel, jcfg, tx)
    state = _port_state(cfg, params, bstats, teacher,
                        lambda ps: optim.make_optimizer(cfg.model.optim, ps, 100))
    for i in range(2):
        batch = _batch(jcfg, seed=10 * i)
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, batch, key)
        m = _port_step(state, jcfg, batch, key)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
        assert m["momentum"] == pytest.approx(float(jm["momentum"]), abs=1e-7)
    assert state.step == int(jstate.step) == 2
    got = _student_tree(state.model)
    want = jax.device_get((jstate.params, jstate.batch_stats, jstate.teacher))
    for g, w in zip(got, want):
        g, w = dict(_leaves(g)), dict(_leaves(w))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=2e-5, rtol=0, err_msg="/".join(k))


def test_layerdrop_skipped_layers_get_zero_gradients_and_decay():
    """With every layer dropped, the skipped layers' gradients are zeros (not
    None) and AdamW still moves them by the weight decay alone, as optax
    does for a leaf whose gradient is zero."""
    cfg, jcfg = _tiny(layerdrop=1.0)
    model = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.init_weights(torch.Generator().manual_seed(0))
    state = tspiral.make_pretrain_state(
        model, lambda ps: optim.AdamW(ps, 1e-2, weight_decay=0.1))
    layer = model.feature_encoder.block_modules[2].layers[0]
    w0 = layer.fc1.weight.detach().clone()
    m = tspiral.pretrain_step(state, tspiral.batch_to_device(_batch(jcfg), "cpu"),
                              DropoutRng.seeded(0, "cpu"))
    assert m["student_layers"] == 0 and m["teacher_layers"] == 0
    assert layer.fc1.weight.grad is not None and not layer.fc1.weight.grad.any()
    torch.testing.assert_close(layer.fc1.weight.detach(), w0 * (1 - 1e-2 * 0.1),
                               rtol=1e-6, atol=0)


def test_training_dropout_needs_an_explicit_rng():
    cfg, jcfg = _tiny(attention_dropout=0.1)
    model = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True).train()
    specs, lens = torch.zeros(1, 32, 16), torch.tensor([32])
    with pytest.raises(ValueError, match="DropoutRng"):
        model.encode_student(specs, lens)
    rng = DropoutRng.seeded(0, "cpu")
    pred, _ = model.encode_student(specs, lens, rng)
    assert pred.shape == (1, 4, 16) and torch.isfinite(pred).all()


# ---- runners and the CLI ----------------------------------------------------

def test_runners_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpiralFinetuneRunner(spiral_tiny_ctc_char(), str(tmp_path), CharTokenizer())
    with pytest.raises(RuntimeError, match="CUDA"):
        SpiralPretrainRunner(spiral_tiny_pretrain(), str(tmp_path))


def _toy_manifest(root, n=5):
    r = np.random.default_rng(0)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        for i in range(n):
            d = 0.5 + 0.1 * i
            path = os.path.join(root, f"u{i}.wav")
            write_wav(path, (r.standard_normal(int(SR * d)) * 0.1).astype(np.float32), SR)
            f.write(json.dumps({"audio_filepath": path, "duration": d, "text": "a"}) + "\n")


def test_cli_train_mode_runs_the_tiny_pretrain(tmp_path, capsys):
    """run_spiral --model_type st2vec --run_mode train on a toy manifest:
    the steps run on the plain versions, the metrics are finite, and the
    saved state_dict converts strictly with the JAX package's
    convert_st2vec."""
    _toy_manifest(str(tmp_path))
    before = dict(_build.LAUNCHES)
    out = run_spiral.main([
        "--model_type", "st2vec", "--run_mode", "train",
        "--config_name", "spiral_tiny_pretrain", "--manifest_dir", str(tmp_path),
        "--model_save_dir", str(tmp_path / "run"), "--device", "cpu",
        "--set", "trainer.max_steps=2", "--set", "model.train_ds.num_workers=1",
    ])
    assert _build.LAUNCHES == before
    assert out["iteration"] == 2 and len(out["steps"]) == 2
    for m in out["steps"]:
        assert np.isfinite(m["loss"]) and 0.0 <= m["accuracy"] <= 1.0
        assert m["teacher_layers"] == m["student_layers"] == 2
    assert "Epoch 1: loss =" in capsys.readouterr().out
    sd = torch.load(out["state_dict"], weights_only=True)
    params, bstats, teacher = torch_spiral.convert_st2vec({k: _np(v) for k, v in sd.items()})
    assert set(teacher) == {"feature_encoder", "projector"} and "predictor" in bstats
    assert os.path.exists(tmp_path / "run" / "train.log")


def _counting_runner(tmp_path, accum, n_utts=6):
    """A tiny pretrain runner (batch 2, accum ``accum``) over ``n_utts``
    utterances whose step records its micro-batches instead of running."""
    _toy_manifest(str(tmp_path), n=n_utts)
    cfg = spiral_tiny_pretrain()
    cfg.trainer.accumulate_grad_batches = accum
    cfg.model.train_ds.manifest_filepath = str(tmp_path / "manifest.json")
    cfg.model.train_ds.num_workers = 1
    runner = SpiralPretrainRunner(cfg, str(tmp_path / "run"), device="cpu")
    calls = []

    def step(batch):
        calls.append(batch)
        return {"loss": torch.tensor(1.0), "accuracy": torch.tensor(0.5)}

    runner.step = step
    return runner, calls


def test_pretrain_runner_shift_seeds_equal_the_jax_runner(tmp_path):
    """Each micro-batch's teacher shifts come from default_rng(1_000_003 +
    update * accum + micro), as the JAX runner's _augment seeds them; the
    host generator's masks follow in the same order."""
    import types

    from tpu_speech.train.spiral_runner import SpiralPretrainRunner as JaxPretrainRunner

    runner, _ = _counting_runner(tmp_path, accum=3)
    raw = next(iter(runner.loader))
    jself = types.SimpleNamespace(iteration=0, accum=3, spec_len=runner.spec_len,
                                  enc_cfg=jax_encoder_cfg(runner.enc_cfg),
                                  host_rng=np.random.default_rng(0))
    for it in (0, 4):
        runner.iteration = jself.iteration = it
        for micro in range(3):
            got = runner._augment(raw, micro)
            ref = JaxPretrainRunner._augment(jself, raw, micro_idx=micro)
            for k in ref:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def test_pretrain_runner_updates_once_per_accum_batches_and_carries_leftovers(tmp_path):
    """accum 2 over 3 batches an epoch: epoch 1 makes one update and keeps
    one micro-batch, epoch 2 makes two more from it and its own three; each
    update gets two micro-batches seeded by (update, micro) and the audio
    seconds are counted when an update consumes them."""
    runner, calls = _counting_runner(tmp_path, accum=2)
    assert len(runner.loader) == 3
    runner.train_epoch(1)
    assert runner.iteration == 1 and len(calls) == 1 and len(runner._micro) == 1
    left = runner._micro[0]
    runner.train_epoch(2)
    assert runner.iteration == 3 and len(calls) == 3 and not runner._micro
    assert calls[1][0] is left
    for update, batch in enumerate(calls):
        assert isinstance(batch, list) and len(batch) == 2
        for micro, mb in enumerate(batch):
            shift = np.random.default_rng(1_000_003 + update * 2 + micro)
            assert (mb["shift_k"], mb["shift_r"]) == (
                int(shift.integers(0, 3)), int(shift.integers(0, 3)))
    assert len(runner.history) == 3


def test_cli_train_mode_runs_bf16_with_accumulation(tmp_path):
    """run_spiral with --set model.precision=bf16 --set
    trainer.accumulate_grad_batches=2 on the tiny pretrain config (3 batches
    an epoch: the second update starts from the first epoch's leftover): the
    runner runs both, each update sums two micro-batches' layers, the loss
    is finite and the saved weights are float32."""
    _toy_manifest(str(tmp_path), n=6)
    out = run_spiral.main([
        "--model_type", "st2vec", "--run_mode", "train",
        "--config_name", "spiral_tiny_pretrain", "--manifest_dir", str(tmp_path),
        "--model_save_dir", str(tmp_path / "run"), "--device", "cpu",
        "--set", "trainer.max_steps=2", "--set", "model.train_ds.num_workers=1",
        "--set", "model.precision=bf16", "--set", "trainer.accumulate_grad_batches=2",
        "--set", "trainer.max_epochs=2",
    ])
    assert out["iteration"] == 2 and len(out["steps"]) == 2
    for m in out["steps"]:
        assert np.isfinite(m["loss"]) and m["teacher_layers"] == m["student_layers"] == 4
    sd = torch.load(out["state_dict"], weights_only=True)
    assert all(v.dtype == torch.float32 for k, v in sd.items() if v.is_floating_point())
