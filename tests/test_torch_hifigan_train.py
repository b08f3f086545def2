"""PyTorch port, HiFi-GAN training: the port against the JAX package.

At ``tests/test_train_hifigan.py``'s tiny operating point (hop 16, 8 mels,
256-sample segments, a two-upsampler generator, reduced discriminator
widths). Weights are the JAX package's own initialisation, carried into the
port by the converters of ``compat/jax_hifigan.py`` and
``compat/jax_gradtts.py::hifigan_from_jax``; JAX's moment trees go through
the same converters, so gradients and moments are compared leaf for leaf
under the port's names. Each test states its bound.
"""

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_speech.audio.mel import mel_spectrogram as j_mel
from tpu_speech.data.wav import write_wav
from tpu_speech.models import hifigan as j_hifi
from tpu_speech.parallel.mesh import make_mesh
from tpu_speech.train import hifigan as j_train
from tpu_speech_torch.audio.mel import mel_spectrogram
from tpu_speech_torch.cli import inference as t_inference
from tpu_speech_torch.cli import train_hifigan
from tpu_speech_torch.compat.jax_gradtts import hifigan_from_jax
from tpu_speech_torch.compat.jax_hifigan import (
    hifigan_to_jax,
    mpd_from_jax,
    mpd_to_jax,
    msd_from_jax,
    msd_to_jax,
)
from tpu_speech_torch.models import hifigan as t_hifi
from tpu_speech_torch.train import hifigan as t_train
from tpu_speech_torch.train.trainer import batch_to_device
from tests.test_torch_diffvc_train import _no_stand_in_soundfile  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_CFG = dict(n_fft=64, num_mels=8, sampling_rate=1600, hop_size=16, win_size=64, fmin=0.0,
               fmax=800.0)
SEGMENT = 256  # 16 mel frames
GEN = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
PERIODS = (2, 3, 5)  # 256 % 3 and 256 % 5: the reflect-pad case
MPD_CHANNELS = (8, 16, 32, 32)
MSD_SPECS = ((16, 15, 1, 7, 1), (32, 41, 4, 20, 4), (32, 5, 1, 2, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_models():
    return (j_hifi.Generator(**GEN),
            j_hifi.MultiPeriodDiscriminator(periods=PERIODS, channels=MPD_CHANNELS),
            j_hifi.MultiScaleDiscriminator(num_scales=2, disc_specs=MSD_SPECS))


def _port_models():
    return (t_hifi.Generator(**GEN, n_mels=MEL_CFG["num_mels"]),
            t_hifi.MultiPeriodDiscriminator(PERIODS, MPD_CHANNELS),
            t_hifi.MultiScaleDiscriminator(2, MSD_SPECS))


_TREES = {}


def _jax_trees():
    """The JAX package's initial params (numpy leaves), as
    ``tests/test_train_hifigan.py`` makes them."""
    if not _TREES:
        gen, mpd, msd = _jax_models()
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        mel0 = jnp.zeros((1, SEGMENT // MEL_CFG["hop_size"], MEL_CFG["num_mels"]))
        wav0 = jnp.zeros((1, SEGMENT))
        for name, tree in (("gen", gen.init(k1, mel0)), ("mpd", mpd.init(k2, wav0, wav0)),
                           ("msd", msd.init(k3, wav0, wav0))):
            _TREES[name] = jax.tree.map(np.asarray, tree["params"])
    return _TREES


def _state_dicts(gen, mpd, msd):
    """Port state_dicts of three JAX trees (params or moments): the
    generator's, and the discriminators' under the ``ModuleDict`` names."""
    disc = {f"mpd.{k}": v for k, v in mpd_from_jax(mpd).items()}
    disc.update({f"msd.{k}": v for k, v in msd_from_jax(msd).items()})
    return hifigan_from_jax(gen), disc


def _port_from_jax(trees):
    gen, mpd, msd = _port_models()
    g_sd, d_sd = _state_dicts(trees["gen"], trees["mpd"], trees["msd"])
    gen.load_state_dict(g_sd, strict=True)
    torch.nn.ModuleDict({"mpd": mpd, "msd": msd}).load_state_dict(d_sd, strict=True)
    return gen, mpd, msd


def _batch(b=2, seed=0):
    """``tests/test_train_hifigan.py::make_batch``: a 110 Hz tone over noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, SEGMENT, dtype=np.float32)
    wav = 0.5 * np.sin(2 * np.pi * 110 * t)[None, :] * np.ones((b, 1))
    return {"wav": (wav + 0.05 * rng.standard_normal((b, SEGMENT))).astype(np.float32)}


# ---------------------------------------------------------------- mel


@pytest.mark.parametrize("cfg", [
    dict(), MEL_CFG, dict(MEL_CFG, fmax=800.0, win_size=48), dict(fmax=11025.0)],
    ids=["v1", "tiny", "tiny-short-window", "v1-fullband"])
def test_mel_spectrogram_and_its_gradient_equal_jax(cfg):
    """Values within 1e-5 (log-mel units) and the gradient of a weighted sum
    with respect to the wav within 1e-5 x its max, (B, N) and (N,) wavs;
    the function always returns float32, also from a bf16 wav."""
    rng = np.random.default_rng(len(cfg))
    wav = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
    want = np.asarray(j_mel(jnp.asarray(wav), **cfg))
    weights = np.linspace(-1, 1, want.size, dtype=np.float32).reshape(want.shape)
    want_g = np.asarray(jax.grad(lambda w: jnp.sum(j_mel(w, **cfg) * weights))(jnp.asarray(wav)))
    w = torch.tensor(wav, requires_grad=True)
    got = mel_spectrogram(w, **cfg)
    (got * _t(weights)).sum().backward()
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), want_g, rtol=0,
                               atol=1e-5 * np.abs(want_g).max())
    np.testing.assert_allclose(mel_spectrogram(_t(wav[0]), **cfg).numpy(), want[0], rtol=0,
                               atol=1e-5)
    assert mel_spectrogram(_t(wav).to(torch.bfloat16), **cfg).dtype == torch.float32


# ---------------------------------------------------------------- discriminators


def _nchw_to_nhwc(f):
    return f.permute(0, 2, 3, 1) if f.dim() == 4 else f.transpose(1, 2)


@pytest.mark.parametrize("which", ["mpd", "msd"])
@pytest.mark.parametrize("n", [SEGMENT, 250], ids=["n256", "n250"])
def test_discriminator_scores_and_feature_maps_equal_jax(which, n):
    """Every discriminator's score and every feature map (the port's
    channels-first maps laid out as JAX's channels-last) within 1e-5 x
    max(1, max|JAX|), on the real and the generated wav. 256 samples pad
    for periods 3 and 5, 250 for 3 (and fold evenly for 2 and 5)."""
    rng = np.random.default_rng(n)
    y, y_hat = (rng.uniform(-0.9, 0.9, (2, n)).astype(np.float32) for _ in range(2))
    trees = _jax_trees()
    jm = _jax_models()[1 if which == "mpd" else 2]
    rs, gs, fr, fg = jm.apply({"params": trees[which]}, jnp.asarray(y), jnp.asarray(y_hat))
    port = _port_from_jax(trees)[1 if which == "mpd" else 2]
    with torch.no_grad():
        (prs, pfr), (pgs, pfg) = port(_t(y)), port(_t(y_hat))
    for want, got in ((rs, prs), (gs, pgs)):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * max(1, np.abs(a).max()))
    for want, got in ((fr, pfr), (fg, pfg)):
        for maps_j, maps_t in zip(want, got):
            assert len(maps_j) == len(maps_t)
            for a, b in zip(maps_j, maps_t):
                a = np.asarray(a)
                b = _nchw_to_nhwc(b).numpy()
                assert b.shape == a.shape
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * max(1, np.abs(a).max()))


def test_losses_equal_jax():
    """feature_loss, discriminator_loss and generator_loss (with their
    per-output lists) within 1e-6 relative on the same arrays."""
    rng = np.random.default_rng(3)
    outs = [rng.standard_normal((2, k)).astype(np.float32) for k in (5, 7, 3)]
    gens = [rng.standard_normal((2, k)).astype(np.float32) for k in (5, 7, 3)]
    fr = [[rng.standard_normal((2, 4, k)).astype(np.float32) for k in (9, 3)] for _ in range(2)]
    fg = [[rng.standard_normal((2, 4, k)).astype(np.float32) for k in (9, 3)] for _ in range(2)]
    tt = lambda xs: [_t(x) for x in xs]  # noqa: E731
    np.testing.assert_allclose(float(t_hifi.feature_loss([tt(f) for f in fr], [tt(f) for f in fg])),
                               float(j_hifi.feature_loss(fr, fg)), rtol=1e-6)
    lt, rt, gt = t_hifi.discriminator_loss(tt(outs), tt(gens))
    lj, rj, gj = j_hifi.discriminator_loss(outs, gens)
    np.testing.assert_allclose([float(lt)] + [float(v) for v in rt + gt],
                               [float(lj)] + [float(v) for v in rj + gj], rtol=1e-6)
    lt, it = t_hifi.generator_loss(tt(gens))
    lj, ij = j_hifi.generator_loss(gens)
    np.testing.assert_allclose([float(lt)] + [float(v) for v in it],
                               [float(lj)] + [float(v) for v in ij], rtol=1e-6)


# ---------------------------------------------------------------- converters


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_converters_are_exact_both_ways_and_strict():
    """JAX -> port -> JAX returns every tree exactly (the generator through
    hifigan_from_jax and hifigan_to_jax); a stray leaf or tensor raises."""
    trees = _jax_trees()
    _assert_trees_equal(hifigan_to_jax(hifigan_from_jax(trees["gen"])), trees["gen"])
    _assert_trees_equal(mpd_to_jax(mpd_from_jax(trees["mpd"]), PERIODS), trees["mpd"])
    _assert_trees_equal(msd_to_jax(msd_from_jax(trees["msd"])), trees["msd"])
    gen, mpd, msd = _port_from_jax(trees)  # strict loads: every port name is filled
    stray = dict(trees["msd"], extra={"kernel": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        msd_from_jax(stray)
    sd = dict(mpd.state_dict(), **{"discriminators.9.convs.0.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unconsumed"):
        mpd_to_jax(sd, PERIODS)
    with pytest.raises(ValueError, match="unconsumed"):
        hifigan_to_jax(dict(gen.state_dict(), stray=torch.zeros(1)))


def test_v1_parameter_counts_equal_jax():
    """At V1 width, from shapes alone: the generator, MPD and MSD hold as
    many parameters as the JAX modules (about 13.9, 41.1 and 29.6 M), and
    the converters map every V1 leaf."""
    mel0 = jax.ShapeDtypeStruct((1, 32, 80), jnp.float32)
    wav0 = jax.ShapeDtypeStruct((1, 8192), jnp.float32)
    key = jax.random.PRNGKey(0)
    shapes = {
        "gen": jax.eval_shape(j_hifi.Generator().init, key, mel0)["params"],
        "mpd": jax.eval_shape(j_hifi.MultiPeriodDiscriminator().init, key, wav0, wav0)["params"],
        "msd": jax.eval_shape(j_hifi.MultiScaleDiscriminator().init, key, wav0, wav0)["params"]}
    with torch.device("meta"):
        port = {"gen": t_hifi.Generator(), "mpd": t_hifi.MultiPeriodDiscriminator(),
                "msd": t_hifi.MultiScaleDiscriminator()}
    for name, tree in shapes.items():
        n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
        n_port = sum(p.numel() for p in port[name].parameters())
        assert n_port == n_jax, (name, n_port, n_jax)
        zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)
        convert = {"gen": hifigan_from_jax, "mpd": mpd_from_jax, "msd": msd_from_jax}[name]
        sd = convert(zeros)
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(p.shape) for k, p in port[name].named_parameters()}
    assert round(sum(p.numel() for p in port["mpd"].parameters()) / 1e6, 1) == 41.1


# ---------------------------------------------------------------- the GAN step

GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
LR = 2e-4


def _jax_run(batches, bf16=False):
    """make_gan_train_step with make_optimizers(LR, steps_per_epoch=1) over
    ``batches`` from the JAX init: per step (metrics, (mu, nu) trees of the
    generator and of {"mpd", "msd"}), and the final params."""
    gen, mpd, msd = _jax_models()
    trees = _jax_trees()
    tx_g, tx_d = j_train.make_optimizers(LR, steps_per_epoch=1)
    state = j_train.GANTrainState.create(*(jax.tree.map(jnp.asarray, trees[k])
                                           for k in ("gen", "mpd", "msd")), tx_g, tx_d)
    step = j_train.make_gan_train_step(gen, mpd, msd, tx_g, tx_d, MEL_CFG, bf16=bf16)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        adam_g, adam_d = state.opt_g[0], state.opt_d[0]
        out.append(({k: float(v) for k, v in m.items()},
                    jax.tree.map(np.asarray, (adam_g.mu, adam_g.nu, adam_d.mu, adam_d.nu))))
    return out, jax.tree.map(np.asarray, (state.gen, state.disc))


def _port_run(batches, bf16=False):
    """The port's gan_train_step over ``batches`` from the same weights:
    per step (metrics, the generator's and the discriminators' gradients),
    and the final (gen, disc, opt_g, opt_d)."""
    gen, mpd, msd = _port_from_jax(_jax_trees())
    disc = torch.nn.ModuleDict({"mpd": mpd, "msd": msd})
    opt_g, opt_d = t_train.make_optimizers(gen, disc, LR, steps_per_epoch=1)
    out = []
    for b in batches:
        # oneDNN off: this CPU build's oneDNN bf16 conv_transpose1d input
        # gradient is wrong at ups.0's shape (16 -> 8 channels, k 8, stride
        # 4, padding 2: 112 % of its max off fp32, 0.24 % without oneDNN)
        with torch.backends.mkldnn.flags(enabled=not bf16):
            m = t_train.gan_train_step(gen, mpd, msd, opt_g, opt_d, batch_to_device(b, "cpu"),
                                       MEL_CFG, bf16=bf16)
        out.append(({k: float(v) for k, v in m.items()},
                    {n: p.grad.clone() for n, p in gen.named_parameters()},
                    {n: p.grad.clone() for n, p in disc.named_parameters()}))
    return out, (gen, disc, opt_g, opt_d)


def _jax_grads(moments, prev, b1=0.8):
    """A step's gradients from AdamW's first moments: g = (mu - b1 mu_prev)
    / (1 - b1)."""
    return jax.tree.map(lambda m, p: (m - b1 * p) / (1 - b1), moments,
                        jax.tree.map(np.zeros_like, moments) if prev is None else prev)


def _jax_step_grads(jax_steps):
    """Per step, the generator's and the discriminators' gradients as port
    state_dicts."""
    out, prev = [], None
    for _, (mu_g, _, mu_d, _) in jax_steps:
        g = _jax_grads((mu_g, mu_d), prev)
        out.append(_state_dicts(g[0], g[1]["mpd"], g[1]["msd"]))
        prev = (mu_g, mu_d)
    return out


def _assert_grads_close(got, want):
    """Each leaf within GRAD_RTOL x its max|g| or GRAD_FLOOR x the largest
    gradient anywhere."""
    assert got.keys() == want.keys()
    g_max = max(float(g.abs().max()) for g in want.values())
    for k, g_ref in want.items():
        bound = max(GRAD_RTOL * float(g_ref.abs().max()), GRAD_FLOOR * g_max)
        err = float((got[k] - g_ref).abs().max())
        assert err <= bound, (k, err, bound)


def _fine_tuning_batches():
    """Batches with an acoustic model's mel: the JAX mel of another wav,
    shifted, so that it differs from the wav's own."""
    out = []
    for s in (0, 1):
        b = _batch(seed=s)
        other = _batch(seed=s + 10)["wav"][:, ::-1].copy()
        b["mel"] = np.asarray(j_mel(jnp.asarray(other), **MEL_CFG)) + 0.3
        out.append(b)
    return out


@pytest.mark.parametrize("mode", ["train", "fine_tuning"])
def test_two_gan_steps_equal_jax(mode):
    """Two steps of the port against make_gan_train_step, steps_per_epoch 1
    (so that the lr decays to 0.999 lr at step 2): the seven metrics within
    1e-5 relative; each step's gradients (JAX's from AdamW's first moments)
    within 1e-4 x the leaf's max|g| (floored at 1e-6 x the largest); the
    moments after two steps within 1e-4 x max|mu| and 2e-4 x max|nu| per
    leaf; the parameters within 1e-6 of JAX's (lr 2e-4; measured 1.5e-7:
    no leaf here holds a gradient at rounding level, where Adam's first
    steps move by lr sign(g)). A gradient of the generator loss that leaked into the
    discriminators' .grad or optimizer would move step 2's discriminator
    update."""
    batches = [_batch(seed=0), _batch(seed=1)] if mode == "train" else _fine_tuning_batches()
    jax_steps, (jgen, jdisc) = _jax_run(batches)
    port_steps, (gen, disc, opt_g, opt_d) = _port_run(batches)
    assert opt_g.count == opt_d.count == 2
    for (mj, _), (mp, _, _) in zip(jax_steps, port_steps):
        assert mp.keys() == mj.keys()
        np.testing.assert_allclose([mp[k] for k in mj], [mj[k] for k in mj], rtol=1e-5)
    for (g_want, d_want), (_, g_got, d_got) in zip(_jax_step_grads(jax_steps), port_steps):
        _assert_grads_close(g_got, g_want)
        _assert_grads_close(d_got, d_want)

    mu_g, nu_g, mu_d, nu_d = jax_steps[-1][1]
    mus, nus = _state_dicts(mu_g, mu_d["mpd"], mu_d["msd"]), _state_dicts(nu_g, nu_d["mpd"],
                                                                           nu_d["msd"])
    for model, opt, mu, nu in ((gen, opt_g, mus[0], nus[0]), (disc, opt_d, mus[1], nus[1])):
        for n, p in model.named_parameters():
            st = opt.state[p]
            assert float((st["mu"] - mu[n]).abs().max()) <= 1e-4 * float(mu[n].abs().max()), n
            assert float((st["nu"] - nu[n]).abs().max()) <= 2e-4 * float(nu[n].abs().max()), n
    p_gen, p_disc = _state_dicts(jgen, jdisc["mpd"], jdisc["msd"])
    for model, want in ((gen, p_gen), (disc, p_disc)):
        for n, p in model.named_parameters():
            err = float((p.detach() - want[n]).abs().max())
            assert err <= 1e-6, (n, err)


def test_bf16_step_within_twice_the_jax_bf16_error():
    """One bf16 step against make_gan_train_step(..., bf16=True), both held
    to the JAX fp32 step (PR 6's rule): with m32 a metric of the fp32 step,
    mj the JAX bf16 step's and mp the port's, |mp - m32| <= 2 |mj - m32| +
    5e-3 |m32| for the seven metrics; per gradient leaf (max|g32| at least
    1 % of the largest), ||gp - g32|| <= 2 ||gj - g32|| + 1e-2 ||g32||. The
    masters, their gradients and AdamW's moments stay float32."""
    batches = [_batch(seed=0)]
    (m32, mom32), = _jax_run(batches)[0]
    (mj, momj), = _jax_run(batches, bf16=True)[0]
    (mp, gp_gen, gp_disc), = _port_run(batches, bf16=True)[0]
    for k in m32:
        assert abs(mp[k] - m32[k]) <= 2 * abs(mj[k] - m32[k]) + 5e-3 * abs(m32[k]), (k, mp, mj)
    (g32_gen, g32_disc), = _jax_step_grads([(m32, mom32)])
    (gj_gen, gj_disc), = _jax_step_grads([(mj, momj)])
    for gp, gj, g32 in ((gp_gen, gj_gen, g32_gen), (gp_disc, gj_disc, g32_disc)):
        assert all(g.dtype == torch.float32 for g in gp.values())
        g_max = max(float(g.abs().max()) for g in g32.values())
        for k, g in g32.items():
            if float(g.abs().max()) < 1e-2 * g_max:
                continue
            err_p, err_j = float((gp[k] - g).norm()), float((gj[k] - g).norm())
            assert err_p <= 2 * err_j + 1e-2 * float(g.norm()), (k, err_p, err_j)


def test_bf16_steps_keep_float32_masters_and_moments():
    """Two bf16 steps: finite float32 metrics, float32 parameters and
    moments, both networks moved."""
    (steps, (gen, disc, opt_g, opt_d)) = _port_run([_batch(seed=0), _batch(seed=1)], bf16=True)
    init = _port_from_jax(_jax_trees())
    for m, _, _ in steps:
        assert all(np.isfinite(v) for v in m.values())
    for model, opt, before in ((gen, opt_g, init[0]),
                               (disc, opt_d, torch.nn.ModuleDict(
                                   {"mpd": init[1], "msd": init[2]}))):
        assert opt.count == 2
        for p in model.parameters():
            assert p.dtype == opt.state[p]["mu"].dtype == opt.state[p]["nu"].dtype == torch.float32
        assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), before.parameters()))


def test_staircase_decay_is_optax_exponential_decay():
    """lr0 x 0.999 ** (count // steps_per_epoch), count 0 at the first
    update: the schedule of optax.exponential_decay(staircase=True) within
    one float32 rounding."""
    import optax

    want = optax.exponential_decay(2e-4, transition_steps=3, decay_rate=0.999, staircase=True)
    got = t_train.staircase_decay(2e-4, 0.999, 3)
    for count in (0, 1, 2, 3, 5, 6, 3000):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=2e-7)
    assert got(2) == got(0) == np.float32(2e-4) and got(3) < got(2)


# ---------------------------------------------------------------- the trainer


def test_trainer_epoch_and_validate_equal_jax(tmp_path):
    """HiFiGANTrainer.train_epoch over two batches and validate on one,
    against the JAX package's HiFiGANTrainer from the same weights: the
    epoch's three means and the validation mel error within 1e-5 relative,
    the train.log line's losses equal as printed, the generator after the
    epoch within 1e-6."""
    gen_j, mpd_j, msd_j = _jax_models()
    jt = j_train.HiFiGANTrainer(gen_j, mpd_j, msd_j, jax.random.PRNGKey(0),
                                log_dir=str(tmp_path / "jax"), mel_cfg=MEL_CFG,
                                steps_per_epoch=2, segment_size=SEGMENT, save_every=100,
                                mesh=make_mesh(n_devices=1))
    trees = jax.tree.map(np.asarray, {"gen": jt.state.gen, **jt.state.disc})
    gen, mpd, msd = _port_from_jax(trees)
    pt = t_train.HiFiGANTrainer(gen, mpd, msd, str(tmp_path / "port"), mel_cfg=MEL_CFG,
                                steps_per_epoch=2)
    batches = [_batch(seed=s) for s in range(2)]
    want = jt.train_epoch(batches, epoch=1, base_rng=jax.random.PRNGKey(1))
    got = pt.train_epoch(batches, epoch=1)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5)
    lines = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "train.log") as f:
            lines.append(f.read().rsplit("|", 1)[0])  # the utt/s differ
    assert lines[0] == lines[1]
    np.testing.assert_allclose(pt.validate(batches, max_batches=1),
                               jt.validate(batches, max_batches=1), rtol=1e-5)
    want_gen = hifigan_from_jax(jax.tree.map(np.asarray, jt.state.gen))
    for n, p in gen.named_parameters():
        assert float((p.detach() - want_gen[n]).abs().max()) <= 1e-6, n
    assert pt.iteration == jt.iteration == 2


# ---------------------------------------------------------------- the CLI


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, caught where its main() parses."""

    class Caught(Exception):
        pass

    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise Caught

    monkeypatch.syspath_prepend(os.path.join(REPO, "cli"))
    spec = importlib.util.spec_from_file_location(
        "jax_cli_train_hifigan", os.path.join(REPO, "cli", "train_hifigan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught):
        mod.main()
    monkeypatch.undo()
    return seen[0]


def test_every_jax_flag_parses_with_the_jax_default(monkeypatch):
    """All 12 options of the JAX CLI exist in the port's parser with the
    same option strings, default, type, action and requiredness; --device
    is the port's only extra; a full command line parses alike."""
    jp, pp = _jax_parser(monkeypatch), train_hifigan.build_parser()
    jflags = {a.dest: a for a in jp._actions if a.option_strings and a.dest != "help"}
    pflags = {a.dest: a for a in pp._actions if a.option_strings and a.dest != "help"}
    assert len(jflags) == 12
    assert set(pflags) - set(jflags) == {"device"}
    for dest, a in jflags.items():
        b = pflags[dest]
        assert (b.option_strings, b.default, b.type, type(b), b.required) == (
            a.option_strings, a.default, a.type, type(a), a.required), dest
    argv = ["--config", "c.json", "--input_wavs_dir", "w", "--input_training_file", "t.txt",
            "--input_validation_file", "v.txt", "--input_mels_dir", "m", "--fine_tuning",
            "--log_dir", "l", "--training_epochs", "3", "--validation_interval", "2",
            "--resume_if_exists", "--bf16", "--num_workers", "1"]
    assert vars(pp.parse_args(argv)).items() >= vars(jp.parse_args(argv)).items()
    assert pp.parse_args(argv).device == "cuda"


TINY_CONFIG = dict(
    resblock="1", upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
    upsample_initial_channel=16, resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]],
    n_fft=64, num_mels=8, sampling_rate=1600, hop_size=16, win_size=64, fmin=0.0, fmax=800.0,
    segment_size=SEGMENT, batch_size=2, learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99,
    lr_decay=0.999, seed=1234)


def _write_corpus(root, n, seed=0):
    """n 1600 Hz wavs of 0.6-2 segments (the short ones zero-pad), a
    training filelist of ids with text after '|', and the config."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        length = int(rng.uniform(0.6, 2.0) * SEGMENT)
        t = np.arange(length) / 1600.0
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(60, 300) * t) + 0.02 * rng.standard_normal(
            length)
        write_wav(os.path.join(root, f"utt{i}.wav"), wav.astype(np.float32), 1600)
        names.append(f"utt{i}")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(f"{n}|some text" for n in names[:-2]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(names[-2:]) + "\n")
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:
        json.dump(TINY_CONFIG, f)
    return names, config


@pytest.fixture
def tiny_discriminators(monkeypatch):
    """The CLI's discriminators at the tiny widths (it builds V1's)."""
    monkeypatch.setattr(train_hifigan, "MultiPeriodDiscriminator",
                        lambda: t_hifi.MultiPeriodDiscriminator(PERIODS, MPD_CHANNELS))
    monkeypatch.setattr(train_hifigan, "MultiScaleDiscriminator",
                        lambda: t_hifi.MultiScaleDiscriminator(2, MSD_SPECS))


def _cli(root, log_dir, epochs, *extra):
    return train_hifigan.main([
        "--config", os.path.join(root, "config.json"), "--input_wavs_dir", root,
        "--input_training_file", os.path.join(root, "train.txt"),
        "--input_validation_file", os.path.join(root, "val.txt"), "--log_dir", log_dir,
        "--training_epochs", str(epochs), "--validation_interval", "1", "--num_workers", "1",
        "--device", "cpu", *extra])


def test_resumed_cli_run_equals_a_straight_run(tmp_path, tiny_discriminators):
    """2 epochs, then --resume_if_exists to 3, against 3 straight epochs (6
    training wavs, B = 2, one loader thread): the third epoch's losses and
    validation, the generator.pt and the last checkpoint's models, moments,
    counts and crop generators equal bit for bit. A checkpoint lands after
    epoch 0 (epoch % 5) and at each run's end; train.log has a line per
    epoch."""
    root = str(tmp_path)
    _write_corpus(root, 8)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = _cli(root, a, 2)
    assert first["first_epoch"] == 0 and first["iteration"] == 6
    assert sorted(os.listdir(os.path.join(a, "ckpt"))) == ["step_0000000003.pt",
                                                           "step_0000000006.pt"]
    resumed = _cli(root, a, 3, "--resume_if_exists")
    straight = _cli(root, b, 3)
    assert resumed["first_epoch"] == 2 and resumed["iteration"] == straight["iteration"] == 9
    assert resumed["epochs"][0] == straight["epochs"][2]
    with open(os.path.join(a, "train.log")) as f:
        assert len(f.read().splitlines()) == 3
    ga, gb = (torch.load(r["generator"], weights_only=True)["generator"]
              for r in (resumed, straight))
    assert ga.keys() == gb.keys() and all(torch.equal(ga[k], gb[k]) for k in ga)
    ca, cb = (torch.load(os.path.join(d, "ckpt", "step_0000000009.pt"), weights_only=True)
              for d in (a, b))
    for part in ("gen", "disc"):
        assert all(torch.equal(ca[part][k], cb[part][k]) for k in ca[part])
    for opt in ("opt_g", "opt_d"):
        assert ca[opt]["count"] == cb[opt]["count"] == 9
        for mom in ("mu", "nu"):
            assert all(torch.equal(ca[opt][mom][k], cb[opt][mom][k]) for k in ca[opt][mom])
    assert ca["data_rngs"] == cb["data_rngs"] and ca["epoch"] == cb["epoch"] == 2


def _jax_load_hifigan(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "cli"))
    spec = importlib.util.spec_from_file_location("jax_cli_inference",
                                                  os.path.join(REPO, "cli", "inference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_hifigan


@pytest.mark.parametrize("mode", ["fp32", "bf16", "fine_tuning"])
def test_cli_generator_pt_vocodes_in_both_packages(tmp_path, tiny_discriminators, monkeypatch,
                                                   mode):
    """One epoch (fp32, --bf16, or --fine_tuning on stored (n_mels, T)
    mels): finite losses, float32 weights, and the generator.pt loads in the
    port's cli/inference.py::load_hifigan and in the JAX CLI's, whose
    vocoded wavs agree within 5e-5 x max(1, max|JAX|)."""
    root = str(tmp_path)
    names, config = _write_corpus(root, 6)
    extra = {"fp32": [], "bf16": ["--bf16"]}.get(mode)
    if mode == "fine_tuning":
        mels = os.path.join(root, "mels")
        os.makedirs(mels)
        rng = np.random.default_rng(1)
        for n in names:
            np.save(os.path.join(mels, f"{n}.npy"),
                    rng.standard_normal((8, 40)).astype(np.float32) - 3)
        extra = ["--fine_tuning", "--input_mels_dir", mels]
    res = _cli(root, str(tmp_path / "logs"), 1, *extra)
    assert res["iteration"] == 2
    assert all(np.isfinite(v) for v in res["epochs"][0].values())
    port = t_inference.load_hifigan(config, res["generator"])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    jgen, jparams = _jax_load_hifigan(monkeypatch)(config, res["generator"])
    mel = np.random.default_rng(2).standard_normal((2, 20, 8)).astype(np.float32) - 3
    want = np.asarray(jgen.apply(jparams, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(_t(mel).transpose(1, 2))[:, 0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-5 * max(1.0, float(np.abs(want).max()))


def test_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _write_corpus(str(tmp_path), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_hifigan.main(["--config", str(tmp_path / "config.json"),
                            "--input_training_file", str(tmp_path / "train.txt"),
                            "--log_dir", str(tmp_path / "logs")])
    assert not os.path.exists(tmp_path / "logs")


def test_training_init_is_the_jax_packages_uniform_init(tiny_discriminators):
    """cli/train_hifigan.py::build_models draws every conv's weight and bias
    uniform in +-1/sqrt(fan_in) with JAX's fan_in (in channels per group x
    kernel, for the transposed convs too): each leaf of the JAX package's
    own init and of the port's lies within that bound and reaches 80 % of
    it (leaves of 64 or more values), and the same seed gives the same
    weights."""
    trees = _jax_trees()
    jax_sd = dict(zip(("gen", "disc"), _state_dicts(trees["gen"], trees["mpd"], trees["msd"])))
    cfg = dict(TINY_CONFIG, resblock_dilation_sizes=[[1, 3]])
    gen, mpd, msd = train_hifigan.build_models(cfg)
    port = {"gen": gen, "disc": torch.nn.ModuleDict({"mpd": mpd, "msd": msd})}
    for part, model in port.items():
        modules = dict(model.named_modules())
        for name, p in model.named_parameters():
            m = modules[name.rsplit(".", 1)[0]]
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, torch.nn.ConvTranspose1d) else w.shape[1]) * \
                w[0, 0].numel()
            bound = fan_in ** -0.5
            for leaf in (p.detach(), jax_sd[part][name]):
                assert float(leaf.abs().max()) <= bound * (1 + 1e-6), (name, bound)
                if leaf.numel() >= 64:
                    assert float(leaf.abs().max()) >= 0.8 * bound, (name, bound)
    again = train_hifigan.build_models(cfg)[0]
    assert all(torch.equal(a, b) for a, b in zip(gen.parameters(), again.parameters()))
