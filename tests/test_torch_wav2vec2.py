"""PyTorch port, wav2vec 2.0 against the JAX package on the CPU: the conv
feature encoder and its lengths, ``grad_multiply``, the Gumbel quantizer,
``Wav2Vec2Model`` (forward and ``extract_features``), one pretraining step in
fp32 and in bf16, ``Wav2Vec2CTCModel`` with ``load_wav2vec_pretrained_encoder``,
the host span mask, and the attention's plain version at wav2vec 2.0 BASE's
head width 96.

Inputs come from numpy seeds; the weights are JAX's init converted by
``compat/jax_wav2vec.py``. The model is ``tests/test_wav2vec_model.py``'s
``TINY`` (two convs, one post-LN 16-wide layer, 6 x 2 codes), dropout off.
The random draws cannot match across frameworks: the step feeds both sides
one Gumbel draw (JAX's ``jax.random.gumbel`` replaced in the test by a numpy
draw) and JAX's negative indices, redrawn on the CPU from the step's key
split (``train/wav2vec.py:67``).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral import wav2vec_model as jw
from tpu_speech.models.spiral.ctc import ctc_loss as jax_ctc_loss
from tpu_speech.models.spiral.quantizer import GumbelVectorQuantizer as JaxQuantizer
from tpu_speech.ops.fused_attention import fused_qkv_self_attention as jax_fused_qkv
from tpu_speech.train import wav2vec as jtrain
from tpu_speech_torch.compat.jax_wav2vec import wav2vec2_ctc_from_jax, wav2vec2_from_jax
from tpu_speech_torch.models.spiral import wav2vec_model as pw
from tpu_speech_torch.models.spiral.ctc import ctc_loss
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.encoder import TransformerCfg
from tpu_speech_torch.models.spiral.quantizer import GumbelVectorQuantizer
from tpu_speech_torch.models.spiral.st2vec import exclude_self
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops.fused_attention import qkv_attention_plain
from tpu_speech_torch.train import wav2vec as ptrain

from tests.test_torch_finetune import _assert_grads_close
from tests.test_torch_pretrain import _jax_raw_negative_indices
from tests.test_wav2vec_model import TINY

jax.config.update("jax_default_matmul_precision", "highest")

ATOL = 1e-5  # a module, the same arithmetic in both packages
STEP_RTOL = 1e-4  # the pretraining step: loss, and each parameter update


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg):
    """The port's Wav2Vec2Config equal field by field to a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["encoder"] = TransformerCfg(**dataclasses.asdict(jcfg.encoder))
    return pw.Wav2Vec2Config(**kw)


def _np(t):
    return t.detach().float().cpu().numpy()


def _wavs(seed=0, b=2, s=200, lens=(200, 160)):
    r = np.random.default_rng(seed)
    wavs = r.standard_normal((b, s)).astype(np.float32)
    lens = np.array(lens, np.int32)
    for i, n in enumerate(lens):
        wavs[i, n:] = 0.0
    return wavs, lens


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, the port's model with them)."""
    wavs, lens = _wavs()
    variables = jw.Wav2Vec2Model(TINY).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "gumbel": jax.random.PRNGKey(2)}, jnp.asarray(wavs), jnp.asarray(lens))
    params = jax.tree.map(np.asarray, variables["params"])
    model = pw.Wav2Vec2Model(port_cfg(TINY))
    model.load_state_dict(wav2vec2_from_jax(params), strict=True)
    return params, model.eval()


# ---- pieces --------------------------------------------------------------------

def test_config_equals_jax_and_base_is_the_reference_recipe():
    assert dataclasses.asdict(pw.wav2vec2_base_config()) == dataclasses.asdict(
        jw.wav2vec2_base_config())
    assert dataclasses.asdict(port_cfg(TINY)) == dataclasses.asdict(TINY)
    base = pw.wav2vec2_base_config()
    assert base.encoder.embedding_dim // base.encoder.num_attention_heads == 96


@pytest.mark.parametrize("lens", [[64, 40, 7], [250000, 160000, 400], [3, 0, 10]])
def test_conv_subsampled_lens_match_jax(lens):
    for cfg in (TINY, jw.wav2vec2_base_config()):
        want = np.asarray(jw.conv_subsampled_lens(cfg, jnp.asarray(lens)))
        np.testing.assert_array_equal(
            pw.conv_subsampled_lens(port_cfg(cfg), torch.tensor(lens)).numpy(), want)
        np.testing.assert_array_equal(pw.conv_subsampled_lens(port_cfg(cfg), np.array(lens)),
                                      want)
    assert int(pw.conv_subsampled_lens(pw.wav2vec2_base_config(), np.array([250000]))[0]) == 781


@pytest.mark.parametrize("mode,bias", [("default", False), ("layer_norm", True)])
def test_conv_feature_encoder_matches_jax(mode, bias):
    """Both extractor modes, the norms moved off 1 and 0."""
    jcfg = dataclasses.replace(TINY, conv_layers=((6, 4, 2), (6, 3, 2), (8, 2, 2)),
                               extractor_mode=mode, conv_bias=bias)
    wavs, lens = _wavs(1, 3, 90, (90, 90, 90))
    r = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: a + 0.1 * r.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, jw.Wav2Vec2Model(jcfg).init(
            {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(1),
             "gumbel": jax.random.PRNGKey(2)}, jnp.asarray(wavs), jnp.asarray(lens))["params"]))
    want = jw.ConvFeatureEncoder(jcfg).apply({"params": params["feature_extractor"]},
                                             jnp.asarray(wavs))
    port = pw.Wav2Vec2Model(port_cfg(jcfg))
    port.load_state_dict(wav2vec2_from_jax(params), strict=True)
    with torch.no_grad():
        got = port.feature_extractor(torch.tensor(wavs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_grad_multiply_scales_the_gradient_only():
    x = torch.ones(3, requires_grad=True)
    y = pw.grad_multiply(x, 0.25)
    assert torch.equal(y, x.detach())
    y.square().sum().backward()
    want = jax.grad(lambda v: jnp.sum(jw.grad_multiply(v, 0.25) ** 2))(jnp.ones((3,)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0, atol=0)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_quantizer_matches_jax(train, weighted):
    """Eval mode (the argmax code) and training mode with JAX's own Gumbel
    draw passed in: quantized vectors, perplexity loss and temperature, and
    the straight-through gradient of the input."""
    r = np.random.default_rng(7)
    b, t, dim = 2, 9, 10
    x = r.standard_normal((b, t, dim)).astype(np.float32)
    weight = (r.random((b, t)) < 0.6).astype(np.float32) if weighted else None
    jq = JaxQuantizer(dim=dim, num_vars=5, groups=2, vq_dim=8)
    key = jax.random.PRNGKey(11)
    params = jax.tree.map(np.asarray, jq.init(
        {"params": jax.random.PRNGKey(3)}, jnp.asarray(x), 0)["params"])

    def jfn(xx):
        out = jq.apply({"params": params}, xx, 1234, train=train, rng=key,
                       weight=None if weight is None else jnp.asarray(weight))
        return out, jnp.sum(out[0] * jnp.arange(8.0)) + out[1]

    want, _ = jfn(jnp.asarray(x))
    jgrad = jax.grad(lambda xx: jfn(xx)[1])(jnp.asarray(x))
    q = GumbelVectorQuantizer(dim, 5, 2, 8).train(train)
    with torch.no_grad():
        q.vars.copy_(torch.tensor(params["vars"]))
        q.weight_proj.weight.copy_(torch.tensor(params["weight_proj"]["kernel"].T))
        q.weight_proj.bias.copy_(torch.tensor(params["weight_proj"]["bias"]))
    xt = torch.tensor(x, requires_grad=True)
    noise = torch.tensor(np.asarray(jax.random.gumbel(key, (b * t, 2, 5), dtype=jnp.float32)))
    out = q(xt, 1234, weight=None if weight is None else torch.tensor(weight), gumbel=noise)
    (out[0] * torch.arange(8.0)).sum().add(out[1]).backward()
    for g, w in zip(out, want):
        np.testing.assert_allclose(np.asarray(_np(g) if torch.is_tensor(g) else g),
                                   np.asarray(w), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), atol=ATOL, rtol=0)


# ---- the model -------------------------------------------------------------------

def _jax_apply(params, wavs, lens, mask=None, **kw):
    return jw.Wav2Vec2Model(TINY).apply({"params": params}, jnp.asarray(wavs),
                                        jnp.asarray(lens), **kw,
                                        time_mask=None if mask is None else jnp.asarray(mask))


def test_model_forward_and_extract_features_match_jax(tiny):
    """Eval mode with a span mask: logits, targets (the argmax codes), the
    loss weight, the feature penalty and the perplexity; then
    ``extract_features``."""
    params, model = tiny
    wavs, lens = _wavs(2)
    t = int(jw.conv_subsampled_lens(TINY, jnp.asarray([200]))[0])
    mask = jtrain.host_time_mask(TINY, lens, t, rng=np.random.default_rng(0))
    want = _jax_apply(params, wavs, lens, mask, num_updates=7)
    with torch.no_grad():
        got = model(torch.tensor(wavs), torch.tensor(lens), torch.tensor(mask), num_updates=7)
    for k in ("logits", "targets", "loss_weight", "features_penalty", "prob_ppl_loss",
              "prob_ppl"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=ATOL, rtol=1e-5,
                                   err_msg=k)
    assert got["cur_temp"] == pytest.approx(float(want["cur_temp"]), rel=1e-6)
    np.testing.assert_array_equal(got["feat_lens"].numpy(), np.asarray(want["feat_lens"]))
    jctx, jl = jw.Wav2Vec2Model(TINY).apply({"params": params}, jnp.asarray(wavs),
                                            jnp.asarray(lens),
                                            method=jw.Wav2Vec2Model.extract_features)
    with torch.no_grad():
        ctx, fl = model.extract_features(torch.tensor(wavs), torch.tensor(lens))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jl))


def test_host_time_mask_equals_jax_from_one_seed():
    lens = np.array([200, 160, 120], np.int32)
    want = jtrain.host_time_mask(TINY, lens, 49, rng=np.random.default_rng(4))
    got = ptrain.host_time_mask(port_cfg(TINY), lens, 49, rng=np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[:, 49 - 4:].all()


# ---- the step --------------------------------------------------------------------

B, S = 2, 200
# TINY with BASE's 320 codes a group. The loss masks each negative equal to
# its positive by an exact comparison of the float targets (st2vec.py's
# contrastive_loss); JAX's straight-through sum y_hard + y_soft - y_soft
# leaves a rounding residue of its own in each target, the port's none
# (test_straight_through_targets_are_exact_codes), so the two find
# different duplicates among TINY's 36 codes. With 320 x 320 codes no
# target of this batch meets an equal negative (asserted), and the step
# compares what both compute alike.
STEP_CFG = dataclasses.replace(TINY, latent_vars=320)


def _step_inputs(decided=False):
    """wavs, lens, the span mask, T, and the Gumbel draw; ``decided`` adds 30
    to one random code of each frame and group, beyond any logit, so that the
    argmax (the code) is the same whatever each framework's bf16 rounding of
    the logits."""
    wavs, lens = _wavs(3, B, S, (S, S - 40))
    t = int(jw.conv_subsampled_lens(STEP_CFG, jnp.asarray([S]))[0])
    mask = jtrain.host_time_mask(STEP_CFG, lens, t, rng=np.random.default_rng(0))
    r = np.random.default_rng(9)
    shape = (B * t, STEP_CFG.latent_groups, STEP_CFG.latent_vars)
    gumbel = r.gumbel(size=shape).astype(np.float32)
    if decided:
        codes = r.integers(0, shape[2], size=shape[:2])
        gumbel += 30.0 * np.eye(shape[2], dtype=np.float32)[codes]
    return wavs, lens, mask, t, gumbel


def _jax_step(monkeypatch, bf16=False, decided=False):
    """One JAX step with optax.sgd(1.0) and the global-norm clip at 1.0 from
    JAX's init, JAX's gumbel draw replaced by the numpy one: (initial params,
    new params, metrics, the step's key)."""
    wavs, lens, mask, t, gumbel = _step_inputs(decided)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=None: jnp.asarray(
        gumbel).reshape(shape))
    model, tx = jw.Wav2Vec2Model(STEP_CFG), optax.sgd(1.0)
    state = jtrain.init_wav2vec_state(model, jax.random.PRNGKey(0), (B, S), tx)
    step = jtrain.make_pretrain_step(model, STEP_CFG, tx, grad_clip=1.0, bf16=bf16)
    key = jax.random.PRNGKey(5)
    params0 = jax.tree.map(np.asarray, state.params["params"])
    new, m = step(state, jnp.asarray(wavs), jnp.asarray(lens), jnp.asarray(mask), key)
    monkeypatch.undo()
    return params0, jax.tree.map(np.asarray, new.params["params"]), jax.device_get(m), key


def _port_step(params0, key, bf16=False, decided=False):
    wavs, lens, mask, t, gumbel = _step_inputs(decided)
    model = pw.Wav2Vec2Model(port_cfg(STEP_CFG))
    model.load_state_dict(wav2vec2_from_jax(params0), strict=True)
    state = ptrain.make_wav2vec_state(model, lambda ps: torch.optim.SGD(ps, lr=1.0))
    feat_lens = jw.conv_subsampled_lens(STEP_CFG, jnp.asarray(lens))
    r_neg = jax.random.split(key, 3)[2]  # the JAX step's split (train/wav2vec.py:67)
    neg = exclude_self(torch.tensor(_jax_raw_negative_indices(r_neg, np.asarray(feat_lens), t,
                                                              STEP_CFG.n_negatives)))
    seen = []
    gather = ptrain.gather_negatives

    def recording(targets, idx):  # the duplicates the loss would mask
        negs = gather(targets, idx)
        seen.append(int((targets[None] == negs).all(-1).sum()))
        return negs

    ptrain.gather_negatives = recording
    try:
        m = ptrain.pretrain_step(state, torch.tensor(wavs), torch.tensor(lens),
                                 torch.tensor(mask), DropoutRng.seeded(0, "cpu"), grad_clip=1.0,
                                 bf16=bf16, neg_idx=neg, gumbel=torch.tensor(gumbel))
    finally:
        ptrain.gather_negatives = gather
    assert seen == [0]
    return state, m


def _deltas(params0, sd):
    ref = wav2vec2_from_jax(params0)
    return {(k,): _np(ref[k]) - _np(v) for k, v in sd.items()}


def test_pretrain_step_fp32_matches_jax(monkeypatch):
    """fp32, the clip at 1.0, optax.sgd(1.0) on both sides (the update is the
    clipped gradient): the loss and the metrics within 1e-4 relative, each
    parameter's update within 1e-4 x its max (floored at 1 % of the largest
    anywhere)."""
    params0, want_new, jm, key = _jax_step(monkeypatch)
    before = dict(_build.LAUNCHES)
    state, m = _port_step(params0, key)
    assert _build.LAUNCHES == before  # the plain versions on the CPU
    for k in ("loss", "contrastive_loss", "accuracy", "prob_ppl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=STEP_RTOL, atol=1e-7,
                                   err_msg=k)
    assert m["cur_temp"] == pytest.approx(float(jm["cur_temp"]), rel=1e-6)
    assert state.step == 1 and m["layers"] == 1
    _assert_grads_close(_deltas(params0, state.model.state_dict()),
                        _deltas(params0, wav2vec2_from_jax(want_new)), rtol=STEP_RTOL)


def test_pretrain_step_bf16_within_twice_the_jax_bf16_error(monkeypatch):
    """bf16=True against the JAX package's own bf16 step (the 2x rule of the
    bf16 parity tests): with
    L32 the JAX fp32 loss, Lj the JAX bf16 loss and Lp the port's,
    |Lp - L32| <= 2 |Lj - L32| + 5e-3 |L32|; per parameter update (max at
    least 1 % of the largest) in L2 norm, ||up - u32|| <= 2 ||uj - u32|| +
    1e-2 ||u32||. The masters and their gradients stay float32. The Gumbel
    draw decides each code (``_step_inputs(decided=True)``): at a near tie
    of the logits, bf16 rounding in either framework may pick another code,
    which moves a target by a whole codebook row."""
    params0, new32, jm32, key = _jax_step(monkeypatch, decided=True)
    _, new16, jm16, _ = _jax_step(monkeypatch, bf16=True, decided=True)
    state, m = _port_step(params0, key, bf16=True, decided=True)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in state.model.parameters())
    l32, lj, lp = float(jm32["loss"]), float(jm16["loss"]), float(m["loss"])
    assert abs(lp - l32) <= 2 * abs(lj - l32) + 5e-3 * abs(l32), (lp, lj, l32)
    u32 = _deltas(params0, wav2vec2_from_jax(new32))
    uj = _deltas(params0, wav2vec2_from_jax(new16))
    up = _deltas(params0, state.model.state_dict())
    u_max = max(float(np.abs(u).max()) for u in u32.values())
    for k, u in u32.items():
        if np.abs(u).max() < 1e-2 * u_max:
            continue
        err_p, err_j = np.linalg.norm(up[k] - u), np.linalg.norm(uj[k] - u)
        assert err_p <= 2 * err_j + 1e-2 * np.linalg.norm(u), (k, err_p, err_j)


def test_straight_through_targets_are_exact_codes():
    """Training-mode quantized vectors are codebook rows bit for bit (the
    straight-through sum adds y_soft - y_soft = 0 exactly), so equal codes
    give equal targets, which the loss's duplicate test relies on; the
    gradient still reaches the logits."""
    q = GumbelVectorQuantizer(6, 3, 2, 4).train()
    x = torch.randn(1, 40, 6, generator=torch.Generator().manual_seed(0), requires_grad=True)
    out, *_ = q(x, 0, generator=torch.Generator().manual_seed(1))
    cb = q.vars.detach().reshape(2, 3, 2)
    for row in out.detach().reshape(40, 2, 2):
        assert all(any(torch.equal(row[g], cb[g, v]) for v in range(3)) for g in range(2))
    (out * torch.arange(4.0)).sum().backward()
    assert x.grad.abs().max() > 0


# ---- the CTC wrapper ---------------------------------------------------------------

def test_ctc_model_with_the_pretrained_encoder_matches_jax(tiny):
    """``load_wav2vec_pretrained_encoder`` grafts the pretraining weights
    (the pretraining-only modules left out, the decoder kept); log-probs and
    the CTC loss equal JAX's on the grafted tree; a frozen encoder gets no
    gradient."""
    params, _ = tiny
    wavs, lens = _wavs(4, B, S, (S, S - 40))
    jmodel = jw.Wav2Vec2CTCModel(TINY, num_classes=5)
    ft = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.asarray(wavs), jnp.asarray(lens))["params"])
    grafted = jw.load_wav2vec_pretrained_encoder(ft, params)
    port = pw.Wav2Vec2CTCModel(port_cfg(TINY), num_classes=5)
    port.load_state_dict(wav2vec2_ctc_from_jax(ft), strict=True)
    assert port.encoder.quantizer is None and "quantizer" not in ft["encoder"]
    before = {k: v.clone() for k, v in port.decoder.state_dict().items()}
    pw.load_wav2vec_pretrained_encoder(port, wav2vec2_from_jax(params))
    assert all(torch.equal(v, port.decoder.state_dict()[k]) for k, v in before.items())
    np.testing.assert_array_equal(port.encoder.mask_emb.detach().numpy(), params["mask_emb"])
    port.eval()
    labels = np.random.default_rng(5).integers(0, 5, size=(B, 4)).astype(np.int32)
    label_lens = np.array([4, 3], np.int32)

    def jloss(p):
        lp, ll = jmodel.apply({"params": p}, jnp.asarray(wavs), jnp.asarray(lens), train=False)
        return jax_ctc_loss(lp, ll, jnp.asarray(labels), jnp.asarray(label_lens),
                            jmodel.blank_idx), (lp, ll)

    (jl, (jlp, jll)), _ = jax.value_and_grad(jloss, has_aux=True)(grafted)
    lp, ll = port(torch.tensor(wavs), torch.tensor(lens))
    np.testing.assert_array_equal(ll.numpy(), np.asarray(jll))
    np.testing.assert_allclose(_np(lp), np.asarray(jlp), atol=ATOL, rtol=0)
    loss = ctc_loss(lp, ll, torch.tensor(labels), torch.tensor(label_lens), port.blank_idx)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert port.blank_idx == jmodel.blank_idx == 5
    port.zero_grad()
    lp, ll = port(torch.tensor(wavs), torch.tensor(lens), freeze_encoder=True)
    ctc_loss(lp, ll, torch.tensor(labels), torch.tensor(label_lens), port.blank_idx).backward()
    assert all(p.grad is None for p in port.encoder.parameters())
    assert any(p.grad is not None and p.grad.abs().max() > 0 for p in port.decoder.parameters())


def test_pretrained_encoder_refuses_a_foreign_state_dict():
    port = pw.Wav2Vec2CTCModel(port_cfg(TINY), num_classes=5)
    with pytest.raises(RuntimeError, match="Missing key"):
        pw.load_wav2vec_pretrained_encoder(port, {"mask_emb": torch.zeros(16)})


# ---- the attention at d_head 96 ------------------------------------------------------

@pytest.mark.parametrize("t", [7, 70])
def test_attention_plain_at_d_head_96_matches_jax(t):
    """wav2vec 2.0 BASE's head width (768 / 8) with padded keys, the plain
    version of K2 against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(96 + t)
    b, h, d = 2, 2, 96
    e = h * d
    qkv = rng.standard_normal((b, t, 3 * e)).astype(np.float32)
    qkv[..., :e] *= d ** -0.5
    mask = np.arange(t)[None, :] >= np.array([t, max(1, t // 2)])[:, None]
    want = jax_fused_qkv(jnp.asarray(qkv), h, jnp.asarray(mask), interpret=True)
    got = qkv_attention_plain(torch.tensor(qkv), h, torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
