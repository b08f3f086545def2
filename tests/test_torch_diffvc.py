"""PyTorch port, DiffVC voice-conversion serving: the port against the JAX
package.

At ``tests/test_diffvc_parity.py``'s small config (16 feats, 32 channels, 2
layers, dec_dim 32), on the same numpy inputs, with weights carried both
ways: JAX-initialised trees through the port's ``diffvc_from_jax`` and
``speaker_encoder_from_jax``, and the port's ``state_dict`` through the JAX
package's ``convert_diffvc`` and ``convert_speaker_encoder``. The norms'
scales and every bias are drawn away from their initial 1 and 0, and the
rezero gains from [0.01, 0.02), so that each parameter shapes the output.
Tolerances: the coefficient tables 1e-6 relative where they do not cancel
(see ``test_coefficient_tables_match_jax``); the encoder and the estimator
3e-5 (the JAX package's own parity tests); the samplers and
``voice_convert`` rtol 1e-4, atol 1e-3 (``tests/test_diffvc_parity.py:181``)
with JAX's draws replayed (see ``SCORE_SCALE``); the speaker encoder 1e-5.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tpu_speech.compat.torch_diffvc import convert_diffvc
from tpu_speech.compat.torch_speaker_encoder import convert_speaker_encoder
from tpu_speech.models.diffvc import diffusion as j_diff
from tpu_speech.models.diffvc.vc import DiffVC as JDiffVC
from tpu_speech.models.diffvc.vc import voice_convert as j_voice_convert
from tpu_speech.models import speaker_encoder as j_spk
from tpu_speech_torch.cli import inference_vc
from tpu_speech_torch.compat.jax_diffvc import diffvc_from_jax, speaker_encoder_from_jax
from tpu_speech_torch.configs import diffvc as cfg
from tpu_speech_torch.models import speaker_encoder as t_spk
from tpu_speech_torch.models.diffvc import DiffVC, voice_convert
from tpu_speech_torch.models.diffvc import diffusion as t_diff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    n_feats=16, channels=32, filters=64, heads=2, layers=2, kernel=3,
    dropout=0.1, window_size=4, enc_dim=16, spk_dim=32, use_ref_t=True,
    dec_dim=32, beta_min=0.05, beta_max=20.0,
)
F = CFG["n_feats"]
BMIN, BMAX = CFG["beta_min"], CFG["beta_max"]
SAMPLER_TOL = dict(rtol=1e-4, atol=1e-3)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _away_from_init(tree, rng):
    """Rezero gains from [0.01, 0.02), norm scales from [0.5, 1.5), every
    bias N(0, 0.05): each leaf then moves the output."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _away_from_init(v, rng)
        elif k == "g":
            out[k] = rng.uniform(0.01, 0.02, size=np.shape(v)).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)
        elif k == "bias":
            out[k] = (0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _jax_model(**over):
    return JDiffVC(**dict(CFG, **over))


@functools.lru_cache(maxsize=None)
def _jax_tree(use_ref_t=True, seed=0, score_scale=1.0):
    """DiffVC params from the JAX package's own initialisers. ``score_scale``
    scales the estimator's last conv (see ``_sampler_tree``)."""
    jm = _jax_model(use_ref_t=use_ref_t)
    x, xl = jnp.ones((1, 8, F)), jnp.array([8], jnp.int32)
    init = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.PRNGKey(seed)}, x, xl, x, jnp.ones((1, 256)),
        jax.random.PRNGKey(seed + 1))
    tree = _away_from_init(jax.tree.map(np.asarray, init["params"]),
                           np.random.default_rng(seed))
    for k in ("kernel", "bias"):
        tree["estimator"]["final_conv"][k] = tree["estimator"]["final_conv"][k] * np.float32(
            score_scale)
    return tree


# The samplers on random weights. A random estimator does not cancel the
# drift away from the average voice as a trained score does, so 'ml' (like
# every mode) multiplies the state's distance from it by up to 1/gamma(0, 1)
# ~ 150, and both packages' estimators turn to NaN at inputs of a few
# hundred (the linear attention is quadratic in its input). The sampler
# tests therefore scale the estimator's output by SCORE_SCALE and the draws
# by NOISE_SCALE: the states stay within tens, where the score still moves
# the result by far more than the tolerance.
SCORE_SCALE = 0.02
NOISE_SCALE = 0.01


def _sampler_tree():
    return _jax_tree(score_scale=SCORE_SCALE)


@pytest.fixture
def small_draws(monkeypatch):
    """JAX's draws scaled by NOISE_SCALE; returns the unscaled draw for the
    replay."""
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        NOISE_SCALE * normal(key, shape, dtype))
    return normal


def _port_from_jax(tree, use_ref_t=True):
    model = DiffVC(**dict(CFG, use_ref_t=use_ref_t)).eval()
    model.load_state_dict(diffvc_from_jax(tree, CFG["layers"], use_ref_t), strict=True)
    return model


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def _jax_step_noise(normal, rng, n, shape):
    """The per-step draws of the JAX sampler's 'em'/'ml' scan
    (``diffusion.py:151-156``): split, then normal of the subkey; scaled as
    ``small_draws`` scales them."""
    out = []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(NOISE_SCALE * np.asarray(normal(sub, shape, dtype=jnp.float32)))
    return np.stack(out)


# ---------------------------------------------------------------- algebra


def _ml_table(n, xp, dtype, m=j_diff):
    """The JAX sampler's coefficients (``diffusion.py:115-133``), in its
    order of operations, as table columns; ``xp``/``dtype`` jnp float32 for
    JAX's values, np float64 for the exact ones."""
    h = 1.0 / n
    ts = 1.0 - xp.arange(n, dtype=dtype) * h
    beta = BMIN + (BMAX - BMIN) * ts
    g0 = m.get_gamma(0.0, ts, BMIN, BMAX)
    kappa = m.get_gamma(0, ts - h, BMIN, BMAX) * (
        1.0 - m.get_gamma(ts - h, ts, BMIN, BMAX, p=2.0))
    kappa = kappa / (g0 * beta * h) - 1.0
    omega = m.get_nu(ts - h, ts, BMIN, BMAX) / g0
    omega = omega + m.get_mu(ts - h, ts, BMIN, BMAX) - (0.5 * beta * h + 1.0)
    sigma = m.get_sigma(ts - h, ts, BMIN, BMAX)
    cols = [ts, g0, 1.0 - g0, 0.5 * beta * h + omega, 1.0 + kappa, beta * h, sigma]
    return np.stack([np.asarray(c) for c in cols], 1)


class _F64:
    """The algebra in float64 numpy, for the exact table."""
    get_gamma = staticmethod(lambda s, t, bmin, bmax, p=1.0: np.exp(
        -0.5 * p * (bmin + 0.5 * (bmax - bmin) * (t + s)) * (t - s)))
    get_mu = staticmethod(lambda s, t, a, b: _F64.get_gamma(s, t, a, b) * (
        1 - _F64.get_gamma(0, s, a, b, 2.0)) / (1 - _F64.get_gamma(0, t, a, b, 2.0)))
    get_nu = staticmethod(lambda s, t, a, b: _F64.get_gamma(0, s, a, b) * (
        1 - _F64.get_gamma(s, t, a, b, 2.0)) / (1 - _F64.get_gamma(0, t, a, b, 2.0)))
    get_sigma = staticmethod(lambda s, t, a, b: np.sqrt(
        (1 - _F64.get_gamma(0, s, a, b, 2.0)) * (1 - _F64.get_gamma(s, t, a, b, 2.0))
        / (1 - _F64.get_gamma(0, t, a, b, 2.0))))


@pytest.mark.parametrize("n", [1, 6, 30])
def test_coefficient_tables_match_jax(n):
    """The per-step tables, float32 in JAX's order of operations; t = 1 - i h.

    t, gamma0 and beta h within 1e-6 relative of JAX's. The other columns
    cancel: 1 - gamma0 near t = 0, and omega, kappa and sigma through 1 -
    gamma(t - h, t) ~ beta h, which nu and sigma divide by 1 - gamma(0,
    t)^2. Numpy's and XLA's float32 exp differ in the last bit for about 40 %
    of inputs, and the cancellation takes that to 2.6e-6 (1.5e-4 relative)
    in omega at n = 30. Both tables are that far from the exact (float64)
    one: the port's cancelling columns are held within 2x JAX's own distance
    from it (plus 1e-7 of the column's scale)."""
    table = t_diff.step_table(n, BMIN, BMAX, "ml")
    assert table.dtype == np.float32 and table.shape == (n, 7)
    want = _ml_table(n, jnp, jnp.float32)
    exact = _ml_table(n, np, np.float64, _F64)
    well = [0, 1, 5]
    np.testing.assert_allclose(table[:, well], want[:, well], rtol=1e-6, atol=0)
    for col in (2, 3, 4, 6):
        port_err = np.abs(table[:, col] - exact[:, col]).max()
        jax_err = np.abs(want[:, col] - exact[:, col]).max()
        assert port_err <= 2 * jax_err + 1e-7 * np.abs(exact[:, col]).max(), (col, port_err,
                                                                              jax_err)
    em = t_diff.step_table(n, BMIN, BMAX, "em")
    np.testing.assert_array_equal(em[:, [0, 1, 2, 5]], table[:, [0, 1, 2, 5]])
    np.testing.assert_allclose(em[:, 3], want[:, 5] * 0.5, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(em[:, 4], 1.0)
    np.testing.assert_allclose(em[:, 6], np.asarray(jnp.sqrt(jnp.asarray(want[:, 5]))),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t_diff.step_table(n, BMIN, BMAX, "pf")[:, 6], 0)


def test_sde_algebra_and_diffused_mean_match_jax(rng):
    for s, t in [(0.0, 0.5), (0.3, 0.7), (0.9, 1.0), (0.0, 1.0), (0.5, 0.5 + 1 / 30)]:
        for name in ("get_gamma", "get_mu", "get_nu", "get_sigma"):
            if name != "get_gamma" and s == 0:
                continue
            got = float(getattr(t_diff, name)(s, t, BMIN, BMAX))
            want = float(getattr(j_diff, name)(s, t, BMIN, BMAX))
            assert got == pytest.approx(want, rel=1e-6, abs=0), (name, s, t)
    x0 = rng.standard_normal((2, 12, F)).astype(np.float32)
    mean = rng.standard_normal((2, 12, F)).astype(np.float32)
    mask = _mask([12, 7], 12)
    for t in (1.0, 0.4):  # a Python float, and a 0-d tensor as the dpm sampler's
        want = np.asarray(j_diff.compute_diffused_mean(
            jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(mean), t, BMIN, BMAX))
        for tt in (t, torch.tensor(t)):
            got = t_diff.compute_diffused_mean(_t(x0), _t(mask)[:, :, None], _t(mean), tt,
                                               BMIN, BMAX)
            # the weights' last bit (numpy's, torch's and XLA's exp) moves a
            # value by up to one rounding of the largest
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------- weights


def test_state_dict_goes_both_ways_exactly():
    """JAX tree -> diffvc_from_jax -> convert_diffvc gives it back bit for
    bit, and the port's state_dict survives the round trip the other way;
    with and without the reference's RefBlock."""
    for use_ref_t in (True, False):
        tree = _jax_tree(use_ref_t)
        model = _port_from_jax(tree, use_ref_t)
        back = jax.tree.map(np.asarray, convert_diffvc(model.state_dict(), use_ref_t,
                                                       CFG["layers"]))["params"]
        flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))
        sd = model.state_dict()
        sd2 = diffvc_from_jax(back, CFG["layers"], use_ref_t)
        assert sorted(sd2) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(sd2[k], v), k


def test_diffvc_from_jax_is_strict():
    tree = jax.tree.map(np.copy, _jax_tree())
    tree["estimator"]["stray"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        diffvc_from_jax(tree, CFG["layers"])
    tree = jax.tree.map(np.copy, _jax_tree())
    del tree["encoder"]["postnet"]["res"]
    with pytest.raises(KeyError):
        diffvc_from_jax(tree, CFG["layers"])
    # a tree with RefBlock read as one without it leaves the RefBlock unread
    with pytest.raises(ValueError, match="ref_block"):
        diffvc_from_jax(_jax_tree(), CFG["layers"], use_ref_t=False)


def _jax_full_width_params():
    """The JAX DiffVC's parameter count at cli/params_vc.py's width, the
    tree taken with jax.eval_shape so nothing heavy runs."""
    jm = JDiffVC(**cfg.model_kwargs())
    x, xl = jnp.ones((1, 16, cfg.n_mels)), jnp.array([16], jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x, xl, x,
                                            jnp.ones((1, 256)), jax.random.PRNGKey(1),
                                            train=False))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_full_width_param_count_equals_jax():
    n_jax = _jax_full_width_params()
    assert n_jax == 126_259_128
    port = DiffVC(**cfg.model_kwargs())
    assert sum(p.numel() for p in port.parameters()) == n_jax


def test_seeded_init_is_finite_and_repeatable():
    a = DiffVC(**CFG).init_weights(torch.Generator().manual_seed(3)).state_dict()
    b = DiffVC(**CFG).init_weights(torch.Generator().manual_seed(3)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all(), k
    gains = [v for k, v in a.items() if k.endswith(".fn.g")]
    assert gains and all(0.01 <= float(g) < 0.02 for g in gains)


# ---------------------------------------------------------------- encoder / estimator


@pytest.mark.parametrize("lengths", [(24, 24), (24, 17)], ids=["full", "masked"])
def test_encoder_matches_jax(rng, lengths):
    """FwdDiffusion (MelEncoder + PostNet) with masks, 3e-5."""
    tree = _jax_tree()
    model = _port_from_jax(tree)
    b, t = 2, 24
    x = rng.standard_normal((b, t, F)).astype(np.float32)
    mask = _mask(lengths, t)
    out_j = jax.jit(functools.partial(_jax_model().apply, method=JDiffVC.encode))(
        {"params": tree}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out_t = model.encode(_t(x), _t(mask))
    assert np.abs(np.asarray(out_j)).max() > 0.1
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=3e-5)


@pytest.mark.parametrize("use_ref_t", [True, False], ids=["ref_t", "no_ref_t"])
def test_estimator_matches_jax(rng, use_ref_t):
    """GradLogPEstimatorVC with a masked source row and a reference of
    another length (RefBlock does not downsample), 3e-5."""
    tree = _jax_tree(use_ref_t)
    model = _port_from_jax(tree, use_ref_t)
    b, t, tr = 2, 16, 21
    xt = rng.standard_normal((b, t, F)).astype(np.float32)
    mean = rng.standard_normal((b, t, F)).astype(np.float32)
    ref = rng.standard_normal((b, tr, F)).astype(np.float32)
    mask, ref_mask = _mask([16, 12], t), _mask([21, 9], tr)
    c = rng.standard_normal((b, 256)).astype(np.float32)
    tt = np.array([0.4, 0.9], np.float32)
    args = [xt, mask, mean, ref, ref_mask, c, tt]
    out_j = jax.jit(functools.partial(_jax_model(use_ref_t=use_ref_t).apply,
                                      method=JDiffVC.score))(
        {"params": tree}, *map(jnp.asarray, args))
    with torch.no_grad():
        out_t = model.score(*map(_t, args))
    assert np.abs(np.asarray(out_j)).max() > 0.1
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=3e-5)


# ---------------------------------------------------------------- samplers


def _sampler_inputs(rng, b=2, t=12, tr=10):
    arrs = {k: rng.standard_normal((b, n, F)).astype(np.float32)
            for k, n in (("mean", t), ("ref", tr), ("mean_ref", tr))}
    arrs["z"] = arrs["mean"] + NOISE_SCALE * rng.standard_normal((b, t, F)).astype(np.float32)
    arrs["mask"], arrs["ref_mask"] = _mask([t, 9], t), _mask([tr, 7], tr)
    arrs["c"] = rng.standard_normal((b, 256)).astype(np.float32)
    return arrs


@pytest.mark.parametrize("mode,n", [("pf", 4), ("em", 4), ("ml", 4), ("dpm", 3)])
def test_sampler_matches_jax_with_its_draws_replayed(rng, small_draws, mode, n):
    tree = _sampler_tree()
    model = _port_from_jax(tree)
    a = _sampler_inputs(rng)
    jm, key = _jax_model(), jax.random.PRNGKey(5)
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def score_j(xt, xt_ref, tv):
        return jm.apply({"params": tree}, xt, ja["mask"], ja["mean"], xt_ref, ja["ref_mask"],
                        ja["c"], tv, method=JDiffVC.score)

    out_j = np.asarray(j_diff.reverse_diffusion(
        score_j, ja["z"], ja["mask"], ja["mean"], ja["ref"], ja["ref_mask"], ja["mean_ref"], n,
        BMIN, BMAX, mode=mode, rng=key))
    noise = _jax_step_noise(small_draws, key, n, a["z"].shape) if mode in ("em", "ml") else None
    ta = {k: _t(v) for k, v in a.items()}

    def score_t(xt, xt_ref, tv):
        return model.score(xt, ta["mask"], ta["mean"], xt_ref, ta["ref_mask"], ta["c"], tv)

    with torch.no_grad():
        out_t = t_diff.reverse_diffusion(
            score_t, ta["z"], ta["mask"][:, :, None], ta["mean"], ta["ref"],
            ta["ref_mask"][:, :, None], ta["mean_ref"], n, BMIN, BMAX, mode=mode,
            step_noise=None if noise is None else _t(noise))
    assert 1 < np.abs(out_j).max() < 100
    np.testing.assert_allclose(out_t.numpy(), out_j, **SAMPLER_TOL)
    assert np.abs(out_t.numpy()[1, 9:]).max() == 0  # masked frames stay zero


@pytest.mark.parametrize("mode,n", [("ml", 6), ("dpm", 4)])
def test_voice_convert_matches_jax_with_its_draws_replayed(rng, small_draws, mode, n):
    """The whole conversion: JAX draws z from rng and the steps from
    fold_in(rng, 1) (``vc.py:105-117``); the port takes both as arguments."""
    tree = _sampler_tree()
    model = _port_from_jax(tree)
    t, tr = 16, 19
    x = rng.standard_normal((2, t, F)).astype(np.float32)
    xl = np.array([16, 11], np.int32)
    x[1, 11:] = 0
    xr = rng.standard_normal((2, tr, F)).astype(np.float32)
    xrl = np.array([19, 13], np.int32)
    c = rng.standard_normal((2, 256)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    key = jax.random.PRNGKey(11)
    mean_x_j, y_j = j_voice_convert(_jax_model(), {"params": tree}, jnp.asarray(x),
                                    jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(xrl),
                                    jnp.asarray(c), n, mode, key)
    z_noise = NOISE_SCALE * np.asarray(small_draws(key, x.shape, dtype=jnp.float32))
    step_noise = _jax_step_noise(small_draws, jax.random.fold_in(key, 1), n, x.shape)
    with torch.no_grad():
        mean_x_t, y_t = voice_convert(
            model, _t(x), _t(xl, torch.long), _t(xr), _t(xrl, torch.long), _t(c), n, mode,
            z_noise=_t(z_noise), step_noise=_t(step_noise) if mode == "ml" else None)
    np.testing.assert_allclose(mean_x_t.numpy(), np.asarray(mean_x_j), rtol=0, atol=3e-5)
    assert 1 < np.abs(np.asarray(y_j)).max() < 100
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **SAMPLER_TOL)


def test_sampler_draws_from_its_generator(rng):
    """Without noise arguments the draws come from ``generator``: the same
    seed gives the same mel, another seed another one; masked frames zero."""
    model = DiffVC(**CFG).init_weights(torch.Generator().manual_seed(0)).eval()
    x = _t(rng.standard_normal((1, 12, F)).astype(np.float32))
    xr = _t(rng.standard_normal((1, 9, F)).astype(np.float32))
    c = _t(rng.standard_normal((1, 256)).astype(np.float32))
    lens, rlens = torch.tensor([10]), torch.tensor([9])

    def run(seed):
        with torch.no_grad():
            return voice_convert(model, x, lens, xr, rlens, c, 2, "ml",
                                 generator=torch.Generator().manual_seed(seed))[1]

    a, b, other = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert torch.isfinite(a).all() and a[0, 10:].abs().max() == 0


# ---------------------------------------------------------------- speaker encoder


@functools.lru_cache(maxsize=None)
def _jax_spk_tree(seed=0):
    jm = j_spk.SpeakerEncoder()
    init = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 160, 40)))
    return _away_from_init(jax.tree.map(np.asarray, init["params"]),
                           np.random.default_rng(seed))


def _port_spk(tree):
    model = t_spk.SpeakerEncoder().eval()
    model.load_state_dict(speaker_encoder_from_jax({"params": tree}), strict=True)
    return model


def test_speaker_encoder_matches_jax(rng):
    """The LSTM + Linear + ReLU + L2 embedding of power-mel partials, 1e-5."""
    tree = _jax_spk_tree()
    model = _port_spk(tree)
    frames = (rng.uniform(0, 1, (3, 160, 40)) ** 4 * 5).astype(np.float32)
    want = np.asarray(jax.jit(j_spk.SpeakerEncoder().apply)({"params": tree},
                                                            jnp.asarray(frames)))
    with torch.no_grad():
        got = model(_t(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("seconds", [2.5, 1.3, 0.7])
def test_embed_utterance_matches_jax(rng, seconds):
    """Partials of 160 frames, averaged and normalised; 0.7 s pads one."""
    tree = _jax_spk_tree()
    model = _port_spk(tree)
    wav = (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)
    want = j_spk.embed_utterance(j_spk.SpeakerEncoder(), {"params": tree}, wav)
    with torch.no_grad():
        got = t_spk.embed_utterance(model, wav).numpy()
    assert got.shape == (256,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_speaker_encoder_state_dict_goes_both_ways_exactly():
    """A reference {'model_state': ...} file's tree, GE2E scalars included,
    converts and comes back bit for bit; both converters strict."""
    model = t_spk.SpeakerEncoder().init_weights(torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.similarity_weight.fill_(7.5)
        model.similarity_bias.fill_(-2.25)
        for name, p in model.lstm.named_parameters():
            if name.startswith("bias"):
                p.normal_(0, 0.1)
    sd = model.state_dict()
    tree = convert_speaker_encoder({"model_state": sd})
    back = speaker_encoder_from_jax(tree)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    t_spk.SpeakerEncoder().load_state_dict(back, strict=True)
    # without the GE2E scalars they take the reference's initial values
    plain = speaker_encoder_from_jax({"params": tree["params"]})
    assert float(plain["similarity_weight"]) == 10.0
    assert float(plain["similarity_bias"]) == -5.0
    tree["params"]["lstm"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        speaker_encoder_from_jax(tree)


def test_random_speaker_encoder_is_seeded_torch_not_flax_draws():
    """Without --spk-encoder both CLIs keep a random encoder: flax's init
    from PRNGKey(0) in JAX, a seeded torch init in the port (ROADMAP.md,
    Queue 3). The distributions are flax's (LSTM weights uniform in
    +-1/16, zero biases, the linear weight of std 1/16), the draws are not."""
    model = t_spk.SpeakerEncoder().init_weights(torch.Generator().manual_seed(0))
    jax_tree = jax.tree.map(np.asarray, jax.jit(j_spk.SpeakerEncoder().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 160, 40)))["params"])
    sd = model.state_dict()
    for name, v in sd.items():
        if name.startswith("lstm.weight"):
            assert v.abs().max() <= 1 / 16 and v.std() > 0.03, name
        elif name.startswith("lstm.bias") or name == "linear.bias":
            assert v.abs().max() == 0, name
    assert 0.055 < float(sd["linear.weight"].std()) < 0.07
    theirs = jax_tree["lstm"]["w_ih_l0"]
    assert theirs.shape == tuple(sd["lstm.weight_ih_l0"].shape)
    assert not np.allclose(theirs, sd["lstm.weight_ih_l0"].numpy())


# ---------------------------------------------------------------- the CLI


def _write_wav(path, rng, seconds, f0):
    n = int(22050 * seconds)
    t = np.arange(n) / 22050
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h for h in range(1, 8))
    y *= 0.5 * (1 + np.sin(2 * np.pi * 3 * t)) ** 2
    y = (0.2 * y / np.abs(y).max() + 0.002 * rng.standard_normal(n)).astype(np.float32)
    scipy.io.wavfile.write(path, 22050, (y * 32767).astype(np.int16))
    return n


TINY_CLI = dict(channels=32, filters=64, layers=2, enc_dim=16, spk_dim=32, dec_dim=16)


def test_port_cli_on_cpu_writes_the_converted_wav(tmp_path, monkeypatch, rng):
    """At a tiny width (80 mels, as get_mel and Griffin-Lim need): a
    reference-named .pt and the JAX params' .npz give the same wav, hop x
    (frames - 1) samples long, as the JAX CLI's fast_griffin_lim makes;
    every mode runs; a {'model_state': ...} speaker encoder loads. The
    rezero gains are zero, the reference's init: on random weights the
    sampler's state reaches hundreds (see SCORE_SCALE), where an estimator
    with nonzero gains turns to NaN. The mel is finite; the denoiser's exp
    of such a mel overflows, so the wav's finiteness is only reported."""
    for k, v in TINY_CLI.items():
        monkeypatch.setattr(cfg, k, v)
    model = DiffVC(**cfg.model_kwargs()).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".fn.g"):
                p.zero_()
    pt, npz = str(tmp_path / "diffvc.pt"), str(tmp_path / "diffvc.npz")
    torch.save(model.state_dict(), pt)
    flat = {}

    def walk(node, pre):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, pre + [k])
            else:
                flat["/".join(pre + [k])] = np.asarray(v)

    walk(convert_diffvc(model.state_dict(), cfg.use_ref_t, cfg.layers), [])
    np.savez(npz, **flat)
    spk = t_spk.SpeakerEncoder().init_weights(torch.Generator().manual_seed(1))
    spk_pt = str(tmp_path / "encoder.pt")
    torch.save({"model_state": spk.state_dict(), "step": 3}, spk_pt)
    src, tgt = str(tmp_path / "src.wav"), str(tmp_path / "tgt.wav")
    n_src = _write_wav(src, rng, 0.9, 140.0)
    _write_wav(tgt, rng, 0.8, 220.0)
    frames = n_src // 256

    def run(ckpt, out, *extra):
        return inference_vc.main(["-s", src, "-t", tgt, "-c", ckpt, "--device", "cpu",
                                  "-o", str(tmp_path / out), *extra])

    res = run(pt, "a.wav", "-n", "2", "--spk-encoder", spk_pt)
    assert res["frames"] == frames and res["samples"] == (frames - 1) * 256
    assert set(res["times"]) == {"mels", "embedding", "conversion", "denoise", "griffin_lim"}
    assert res["finite"]["mel"] and isinstance(res["finite"]["wav"], bool)
    sr, pcm = scipy.io.wavfile.read(res["output"])
    assert sr == 22050 and pcm.dtype == np.int16 and pcm.shape == ((frames - 1) * 256,)
    same = run(npz, "b.wav", "-n", "2", "--spk-encoder", spk_pt)
    np.testing.assert_array_equal(scipy.io.wavfile.read(same["output"])[1], pcm)
    for mode in ("pf", "em", "dpm"):
        out = run(pt, f"{mode}.wav", "-n", "1", "--mode", mode)  # random speaker encoder
        assert out["finite"]["mel"]
        assert scipy.io.wavfile.read(out["output"])[1].shape == pcm.shape


def test_port_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_vc.main(["-s", "a.wav", "-t", "b.wav", "-c", str(tmp_path / "w.pt")])


def test_port_cli_refuses_orbax_checkpoints(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        inference_vc.load_diffvc_state_dict(str(tmp_path))


def test_jax_cli_vocodes_with_griffin_lim_only():
    """The JAX CLI's docstring names HiFi-GAN, but its code vocodes with
    fast_griffin_lim alone (``cli/inference_vc.py:5-6, 146-148``); the
    port's CLI follows the code (ROADMAP.md, Queue 3)."""
    with open(os.path.join(REPO, "cli", "inference_vc.py")) as f:
        src = f.read()
    assert "HiFi-GAN" in src.split('"""')[1]
    code = src.split('"""', 2)[2]
    assert "fast_griffin_lim(" in code and "hifigan" not in code.lower()
    spec = importlib.util.find_spec("tpu_speech_torch.cli.inference_vc")
    with open(spec.origin) as f:
        port = f.read().split('"""', 2)[2]
    assert "fast_griffin_lim(" in port and "hifigan" not in port.lower()
