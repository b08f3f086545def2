"""PyTorch port, bf16 DiffVC: conversion on bf16 parameters and inputs
(``bench.py:452-459``) and the bf16 training steps (``train/diffvc.py``'s
``make_enc_train_step``/``make_dec_train_step(..., bf16=True)``), against
the JAX package.

The 2x rule: with R the JAX fp32 run, J JAX's bf16 run and P the port's,
|P - R| <= 2 |J - R| + floor (the sampler's mel: max abs, floor 1e-3 x
max(1, max|R|); losses: floor 5e-3 |R|; gradients per leaf with max|g| at
least 1 % of the largest: L2 norms, floor 1e-2 ||g_R||, as the bf16 Grad-TTS
step test holds them). The fp32 and bf16 runs share their draws: JAX's
float32 normal and uniform, rounded to bf16 in the bf16 runs (a bf16
``jax.random`` draw is another sample, which would set R and J apart by the
noise, not the rounding); the port gets the bf16 runs' draws. The
conversion runs on ``tests/test_torch_diffvc.py``'s sampler weights and
scaled draws (the random-weight samplers diverge otherwise), the steps on
``tests/test_torch_diffvc_train.py``'s tiny models and batches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_speech.models.diffvc.vc import DiffVC as JDiffVC
from tpu_speech.models.diffvc.vc import voice_convert as j_voice_convert
from tpu_speech.train.diffvc import make_dec_train_step, make_enc_train_step
from tpu_speech.train.state import TrainState
from tpu_speech_torch.cli import get_avg_mels, train_dec, train_enc
from tpu_speech_torch.compat.jax_diffvc import diffvc_from_jax, fwd_diffusion_from_jax
from tpu_speech_torch.models.diffvc import voice_convert
from tpu_speech_torch.train import diffvc as t_train
from tpu_speech_torch.train.diffvc import dec_train_step, enc_train_step
from tpu_speech_torch.train.optim import AdamW
from tpu_speech_torch.utils.precision import cast_params_bf16
from tests import test_torch_diffvc as vc_t
from tests import test_torch_diffvc_train as tr_t
from tests.test_torch_diffvc_train import _no_stand_in_soundfile, tiny_cli  # noqa: F401

BF = jnp.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores (a step that takes 0.5 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shared_draws(monkeypatch):
    """jax.random.normal and uniform drawn in float32 and then cast, so that
    an fp32 and a bf16 run see one sample; ``scale`` multiplies the normal
    (the sampler tests' NOISE_SCALE). Returns the unpatched functions."""
    normal, uniform = jax.random.normal, jax.random.uniform
    state = {"scale": 1.0}

    def patched_normal(key, shape=(), dtype=jnp.float32):
        return (state["scale"] * normal(key, shape, jnp.float32)).astype(dtype)

    def patched_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return uniform(key, shape, jnp.float32, minval, maxval).astype(dtype)

    monkeypatch.setattr(jax.random, "normal", patched_normal)
    monkeypatch.setattr(jax.random, "uniform", patched_uniform)
    return state


def _cast(tree):
    return jax.tree.map(lambda p: p.astype(BF) if jnp.issubdtype(p.dtype, jnp.floating) else p,
                        tree)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(a):
    """A float32 array as the bf16 tensor JAX's cast makes of it."""
    return torch.from_numpy(_f32(jnp.asarray(a).astype(BF))).to(torch.bfloat16)


def _within_twice(p, j, r, floor):
    err_p, err_j = float(np.abs(p - r).max()), float(np.abs(j - r).max())
    assert err_p <= 2 * err_j + floor, (err_p, err_j, floor)
    return err_p, err_j


def _grads_within_twice(gp, gj, g32):
    """Per leaf with max|g| at least 1 % of the largest; the one-element
    leaves (the rezero gains, each a sum over the whole grid with heavy
    cancellation) as one vector, since one number is one sample of the
    rounding noise and not a distance: over them, and over the leaves at
    large, the port's ratio to JAX's bf16 error is about 1."""
    g_max = max(float(g.abs().max()) for g in g32.values())
    keys = [k for k, g in g32.items() if float(g.abs().max()) >= 1e-2 * g_max]
    scalars = [k for k in keys if g32[k].numel() == 1]
    groups = [[k] for k in keys if g32[k].numel() > 1] + [scalars]
    for group in groups:
        g = torch.cat([g32[k].flatten() for k in group])
        err_p = float((torch.cat([gp[k].flatten() for k in group]) - g).norm())
        err_j = float((torch.cat([gj[k].flatten() for k in group]) - g).norm())
        assert err_p <= 2 * err_j + 1e-2 * float(g.norm()), (group, err_p, err_j)
    assert len(groups) > 10


# ---------------------------------------------------------------- conversion


@pytest.mark.parametrize("mode,n", [("ml", 6), ("dpm", 4)])
def test_bf16_voice_convert_within_twice_the_jax_bf16_error(rng, shared_draws, mode, n):
    """``voice_convert`` on bf16 parameters with x, x_ref and c in bf16
    (``bench.py:452-459``): mean_x and the converted mel bf16, as JAX's,
    and under the 2x rule against JAX's fp32 conversion."""
    shared_draws["scale"] = vc_t.NOISE_SCALE
    tree = vc_t._sampler_tree()
    model = cast_params_bf16(vc_t._port_from_jax(tree))
    t, tr, f = 16, 16, vc_t.F
    x = rng.standard_normal((2, t, f)).astype(np.float32)
    xl = np.array([16, 11], np.int32)
    x[1, 11:] = 0
    xr = rng.standard_normal((2, tr, f)).astype(np.float32)
    xrl = np.array([16, 13], np.int32)
    c = rng.standard_normal((2, 256)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    key = jax.random.PRNGKey(11)
    runs = {}
    for bf16 in (False, True):
        dt = BF if bf16 else jnp.float32
        params = {"params": _cast(tree) if bf16 else tree}
        mean_x, y = j_voice_convert(vc_t._jax_model(), params, jnp.asarray(x, dt),
                                    jnp.asarray(xl), jnp.asarray(xr, dt), jnp.asarray(xrl),
                                    jnp.asarray(c, dt), n, mode, key)
        assert mean_x.dtype == y.dtype == dt
        runs[bf16] = (_f32(mean_x), _f32(y))
    z_noise = jax.random.normal(key, x.shape, dtype=BF)  # scaled, as the patched JAX draws
    steps, r = [], jax.random.fold_in(key, 1)
    for _ in range(n):
        r, sub = jax.random.split(r)
        steps.append(_f32(jax.random.normal(sub, x.shape, dtype=BF)))
    b = torch.bfloat16
    with torch.no_grad():
        mean_p, y_p = voice_convert(
            model, _bf(x), torch.from_numpy(xl).long(), _bf(xr), torch.from_numpy(xrl).long(),
            _bf(c), n, mode, z_noise=torch.from_numpy(_f32(z_noise)).to(b),
            step_noise=torch.from_numpy(np.stack(steps)).to(b) if mode == "ml" else None)
    assert mean_p.dtype == y_p.dtype == b
    (m32, y32), (m16, y16) = runs[False], runs[True]
    scale = max(1.0, float(np.abs(y32).max()))
    _within_twice(mean_p.float().numpy(), m16, m32, 1e-3 * max(1.0, float(np.abs(m32).max())))
    _, err_j = _within_twice(y_p.float().numpy(), y16, y32, 1e-3 * scale)
    assert err_j > 0


# ---------------------------------------------------------------- the training steps


def _sgd_grads(before, state_after, from_jax, *args):
    """The clipped gradients of one SGD(1) step: the parameters ``before``
    (a numpy tree: the step donates its state) less those after, under the
    port's names."""
    diff = jax.tree.map(lambda a, b: a - np.asarray(b), before, state_after.params["params"])
    return from_jax(diff, *args)


def test_bf16_enc_step_within_twice_the_jax_bf16_error():
    """``enc_train_step(bf16=True)`` against ``make_enc_train_step(...,
    bf16=True)`` with SGD(1) on both sides (the clip engaged): the loss
    and the clipped gradients under the 2x rule against the fp32 step; the
    loss float32, the masters and their gradients float32."""
    tree, bt = tr_t._enc_tree(), tr_t._enc_batch()
    runs = {}
    for bf16 in (False, True):
        step = make_enc_train_step(tr_t._EncNoDropout(**tr_t.ENC), optax.sgd(1.0), bf16=bf16)
        state = TrainState.create({"params": jax.tree.map(jnp.asarray, tree)}, optax.sgd(1.0))
        after, m = step(state, bt, jax.random.PRNGKey(0))
        runs[bf16] = (float(m["loss"]),
                      _sgd_grads(tree, after, fwd_diffusion_from_jax, tr_t.ENC["layers"]))
    model = tr_t._port_enc(tree)
    m = enc_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0),
                       tr_t._port_batch(bt), bf16=True)
    assert m["loss"].dtype == torch.float32 and float(m["grad_norm"]) > 1.0
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    (l32, g32), (lj, gj) = runs[False], runs[True]
    _within_twice(np.float64(m["loss"]), lj, l32, 5e-3 * abs(l32))
    _grads_within_twice({n: p.grad for n, p in model.named_parameters()}, gj, g32)


def test_bf16_dec_step_within_twice_the_jax_bf16_error(shared_draws):
    """``dec_train_step(bf16=True)`` against ``make_dec_train_step(...,
    bf16=True)``, JAX's draws (t and z in bf16, ``diffusion.py:182-185``)
    replayed and SGD(1) on both sides: the loss and the estimator's clipped
    gradients under the 2x rule against the fp32 step; the encoder's
    gradients zero, its weights unchanged; float32 loss, masters and
    gradients."""
    tree, bt = tr_t._vc_tree(), tr_t._dec_batch()
    key = jax.random.PRNGKey(12)
    runs = {}
    for bf16 in (False, True):
        step = make_dec_train_step(JDiffVC(**tr_t.VC), optax.sgd(1.0), bf16=bf16)
        state = TrainState.create({"params": jax.tree.map(jnp.asarray, tree)}, optax.sgd(1.0))
        after, m = step(state, bt, key)
        runs[bf16] = (float(m["loss"]), _sgd_grads(tree, after, diffvc_from_jax,
                                                   tr_t.VC["layers"], tr_t.VC["use_ref_t"]))
    rng_t, rng_z = jax.random.split(key)
    t = jnp.clip(jax.random.uniform(rng_t, (3,), dtype=BF), 1e-5, 1 - 1e-5)
    z = jax.random.normal(rng_z, bt["mel1"].shape, dtype=BF)
    model = tr_t._port_vc().train()
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    m = dec_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0),
                       tr_t._port_batch(bt), t=torch.from_numpy(_f32(t)).bfloat16(),
                       z=torch.from_numpy(_f32(z)).bfloat16(), bf16=True)
    assert m["loss"].dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(torch.equal(v, enc_before[k]) for k, v in model.encoder.state_dict().items())
    named = dict(model.named_parameters())
    assert all(float(named[n].grad.abs().max()) == 0 for n in named if n.startswith("encoder."))
    (l32, g32), (lj, gj) = runs[False], runs[True]
    _within_twice(np.float64(m["loss"]), lj, l32, 5e-3 * abs(l32))
    dec = {n: g for n, g in g32.items() if not n.startswith("encoder.")}
    _grads_within_twice({n: named[n].grad for n in dec}, gj, dec)


@pytest.mark.parametrize("stage", ["enc", "dec"])
def test_bf16_adam_steps_keep_float32_masters_and_moments(stage):
    """Two bf16 steps with the port's Adam and the generator's draws: finite
    float32 losses, float32 parameters and moments, the trained part moved
    (the decoder stage's encoder not)."""
    model = tr_t._port_enc() if stage == "enc" else tr_t._port_vc().train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AdamW(model.parameters(), 1e-3)
    step = enc_train_step if stage == "enc" else dec_train_step
    for i in range(2):
        bt = (tr_t._enc_batch if stage == "enc" else tr_t._dec_batch)(seed=i)
        m = step(model, opt, tr_t._port_batch(bt), torch.Generator().manual_seed(i), bf16=True)
        assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert opt.count == 2
    for n, p in model.named_parameters():
        assert p.dtype == opt.state[p]["mu"].dtype == opt.state[p]["nu"].dtype == torch.float32
        moved = not torch.equal(p.detach(), init[n])
        assert moved == (stage == "enc" or not n.startswith("encoder.")), n


# ---------------------------------------------------------------- the CLIs


def test_clis_train_one_bf16_epoch_on_cpu(tmp_path, tiny_cli, monkeypatch):
    """``train_enc`` and then ``train_dec --precision bf16`` for one epoch
    each on the CPU corpus: finite losses, float32 weights in the saved
    state_dicts (the masters), which ``train_dec --enc-ckpt`` loads."""
    monkeypatch.setattr(t_train, "PREVIEW_TIMESTEPS", 2)
    root = str(tmp_path / "data")
    tr_t.write_vc_corpus(root)
    get_avg_mels.main(["--data-dir", root])
    common = ["--data-dir", root, "--device", "cpu", "--batch-size", "8", "--epochs", "1",
              "--precision", "bf16"]
    r1 = train_enc.main(common + ["--log-dir", str(tmp_path / "enc")])
    assert r1["iteration"] == 2 and np.isfinite(r1["losses"]).all()
    r2 = train_dec.main(common + ["--log-dir", str(tmp_path / "dec"), "--enc-ckpt",
                                  r1["state_dict"]])
    assert r2["iteration"] == 2 and np.isfinite(r2["losses"]).all()
    for path in (r1["state_dict"], r2["state_dict"]):
        assert os.path.exists(path)
        sd = torch.load(path, weights_only=True)
        assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
