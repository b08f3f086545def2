"""PyTorch port, Grad-TTS serving: the port against the JAX package.

At ``tests/test_gradtts_parity.py``'s small config (48 channels, 2 layers,
16 feats, dec_dim 16), on the same numpy inputs, with weights carried both
ways: the port's ``state_dict`` through the JAX package's
``convert_gradtts``, and JAX trees through the port's ``gradtts_from_jax``.
Tolerances are the JAX package's own parity tests' (encoder 2e-5, estimator
2e-5 / 3e-5 multi-speaker, samplers and ``synthesize`` 5e-5). On random
weights the samplers' outputs reach a few hundred (the DPM solver's first
steps divide by alpha ~ 0.007), where fp32 alone puts two implementations
1e-6 relative apart (each is that far from a float64 run of the port), so
the samplers' 5e-5 is taken x max(1, max|JAX|), as the kernels' tolerances
are in ``chip_smoke.py``.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tpu_speech.compat.torch_gradtts import convert_gradtts
from tpu_speech.models import diffusion as j_diff
from tpu_speech.models.grad_tts import GradTTS as JGradTTS
from tpu_speech.models.grad_tts import synthesize as j_synthesize
from tpu_speech.models.text_encoder import TextEncoder as JTextEncoder
from tpu_speech.nn.unet import GradLogPEstimator2d as JEstimator
from tpu_speech.ops import masks as j_masks
from tpu_speech_torch.cli import inference
from tpu_speech_torch.compat.jax_gradtts import gradtts_from_jax
from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.models import diffusion as t_diff
from tpu_speech_torch.models.grad_tts import GradTTS, duration_path, durations, synthesize
from tpu_speech_torch.models.hifigan import Generator
from tpu_speech_torch.ops import masks as t_masks
from tpu_speech_torch.text import symbols

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    n_vocab=50, n_spks=1, spk_emb_dim=16, n_enc_channels=48, filter_channels=96,
    filter_channels_dp=64, n_heads=2, n_enc_layers=2, enc_kernel=3, enc_dropout=0.1,
    window_size=4, n_feats=16, dec_dim=16, beta_min=0.05, beta_max=20.0, pe_scale=1000.0,
)
F = CFG["n_feats"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores (a step that takes 0.5 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(seed, **over):
    model = GradTTS(**dict(CFG, **over))
    return model.init_weights(torch.Generator().manual_seed(seed)).eval()


def _to_jax(model, n_spks=1):
    """The port's state_dict through the JAX package's converter."""
    return jax.tree.map(jnp.asarray, convert_gradtts(
        model.state_dict(), n_spks=n_spks, n_enc_layers=CFG["n_enc_layers"]))


def _with_gains(tree, rng):
    """The rezero gains init at zero: give them values so that every linear
    attention shapes the output."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _with_gains(v, rng)
        elif k == "g":
            out[k] = rng.uniform(0.01, 0.02, size=np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _jax_tree(n_spks, seed=0):
    """GradTTS params from the JAX package's own initialisers (the encoder
    and the estimator, as the GradTTS tree nests them)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    enc = JTextEncoder(CFG["n_vocab"], F, CFG["n_enc_channels"], CFG["filter_channels"],
                       CFG["filter_channels_dp"], CFG["n_heads"], CFG["n_enc_layers"],
                       CFG["enc_kernel"], CFG["enc_dropout"], CFG["window_size"])
    enc_p = jax.jit(enc.init)(k1, jnp.ones((1, 5), jnp.int32), jnp.array([5], jnp.int32))
    enc_p = enc_p["params"]
    est = JEstimator(dim=CFG["dec_dim"], n_spks=n_spks, spk_emb_dim=CFG["spk_emb_dim"],
                     n_feats=F, pe_scale=CFG["pe_scale"])
    spk = jnp.ones((1, CFG["spk_emb_dim"])) if n_spks > 1 else None
    est_p = jax.jit(est.init)(k2, jnp.ones((1, 8, F)), jnp.ones((1, 8)), jnp.ones((1, 8, F)),
                              jnp.ones((1,)), spk)["params"]
    rng = np.random.default_rng(seed)
    tree = {"encoder": enc_p, "estimator": est_p}
    if n_spks > 1:
        tree["spk_emb"] = {"embedding": rng.standard_normal(
            (n_spks, CFG["spk_emb_dim"])).astype(np.float32)}
    return _with_gains(jax.tree.map(np.asarray, tree), rng)


def _ids(rng, t_x, lengths):
    x = rng.integers(1, CFG["n_vocab"], size=(len(lengths), t_x)).astype(np.int32)
    return x, np.asarray(lengths, np.int32)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _assert_close_to_scale(got, ref, tol):
    """|got - ref| <= tol x max(1, max|ref|) everywhere."""
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


# ---------------------------------------------------------------- masks


def test_masks_match_jax(rng):
    lengths = np.array([5, 1, 9], np.int32)
    np.testing.assert_array_equal(
        t_masks.sequence_mask(_t(lengths), 9).numpy(),
        np.asarray(j_masks.sequence_mask(jnp.asarray(lengths), 9)))
    for n in (1, 4, 5, 171, 256):
        for k in (1, 2, 3):
            assert t_masks.fix_len_compatibility(n, k) == j_masks.fix_len_compatibility(n, k)
    # fractional durations, as ceil(w) * length_scale gives them
    dur = np.ceil(rng.uniform(0.1, 3.0, size=(2, 7))) * 0.91
    dur[1, 5:] = 0
    mask = np.ones((2, 7, 20), np.float32)
    mask[1, 5:] = 0
    mask[:, :, 16:] = 0
    path_t = t_masks.generate_path(_t(dur, torch.float32), _t(mask))
    path_j = j_masks.generate_path(jnp.asarray(dur, jnp.float32), jnp.asarray(mask))
    np.testing.assert_array_equal(path_t.numpy(), np.asarray(path_j))


def test_noise_schedule_and_dpm_table_match_jax():
    t = np.linspace(0, 1, 11)
    for cum in (False, True):
        np.testing.assert_allclose(t_diff.get_noise(t, 0.05, 20.0, cum),
                                   j_diff.get_noise(t, 0.05, 20.0, cum), rtol=0, atol=0)
    ts_t, lam_t = t_diff.dpm_solver_schedule(6, 0.05, 20.0)
    ts_j, lam_j = j_diff.dpm_solver_schedule(6, 0.05, 20.0)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(lam_t, lam_j)
    assert t_diff.dpm_coefficients(6, 0.05, 20.0).dtype == np.float32


# ---------------------------------------------------------------- weights


def test_state_dict_goes_both_ways_exactly():
    """port state_dict -> convert_gradtts -> gradtts_from_jax gives it back
    bit for bit, one and three speakers; strict loads both ways."""
    for n_spks in (1, 3):
        model = _port_model(5, n_spks=n_spks)
        sd = model.state_dict()
        back = gradtts_from_jax(convert_gradtts(sd, n_spks=n_spks,
                                                n_enc_layers=CFG["n_enc_layers"]),
                                CFG["n_enc_layers"], n_spks)
        assert sorted(back) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        GradTTS(**dict(CFG, n_spks=n_spks)).load_state_dict(back, strict=True)


def test_gradtts_from_jax_is_strict():
    tree = jax.tree.map(np.asarray, convert_gradtts(_port_model(5).state_dict(),
                                                    n_enc_layers=CFG["n_enc_layers"]))
    tree = tree["params"]
    tree["estimator"]["stray"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        gradtts_from_jax(tree, CFG["n_enc_layers"], 1)


def _jax_full_width_params():
    """The JAX GradTTS's parameter count at cli/params.py's width, the tree
    taken with jax.eval_shape so nothing heavy runs."""
    jm = JGradTTS(**cfg.model_kwargs(len(symbols) + 1))
    x, xl = jnp.ones((1, 7), jnp.int32), jnp.array([7], jnp.int32)
    y, yl = jnp.ones((1, 16, cfg.n_feats)), jnp.array([16], jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x, xl, y, yl,
                                            jax.random.PRNGKey(1), train=False))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_full_width_param_count_equals_jax():
    n_jax = _jax_full_width_params()
    port = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    assert sum(p.numel() for p in port.parameters()) == n_jax


def _jax_cli_params():
    spec = importlib.util.spec_from_file_location("jax_cli_params",
                                                  os.path.join(REPO, "cli", "params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_copy_equals_cli_params():
    theirs = _jax_cli_params()
    names = [n for n in vars(theirs) if not n.startswith("_")
             and isinstance(getattr(theirs, n), (int, float, str, bool))]
    assert len(names) > 30
    for n in names:
        if n != "cmudict_path":  # the JAX module prefers a reference copy when present
            assert getattr(cfg, n) == getattr(theirs, n), n
    assert cfg.cmudict_path == "resources/cmu_dictionary"


# ---------------------------------------------------------------- encoder / estimator


@pytest.mark.parametrize("t_x,lengths", [(11, [11, 7]), (3, [3, 2])],
                         ids=["L11", "L3_below_window"])
def test_encoder_matches_jax(rng, t_x, lengths):
    """mu and logw 2e-5, masks equal; L = 3 < w + 1 = 5 takes
    _windowed_rel_emb's slicing branch."""
    model = _port_model(0)
    params = _to_jax(model)
    x, xl = _ids(rng, t_x, lengths)
    mu_j, logw_j, mask_j = JGradTTS(**CFG).apply(params, jnp.asarray(x), jnp.asarray(xl),
                                                 method=JGradTTS.encode)
    with torch.no_grad():
        mu_t, logw_t, mask_t = model.encode(_t(x, torch.long), _t(xl, torch.long))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(logw_t.numpy(), np.asarray(logw_j), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("n_spks,atol", [(1, 2e-5), (3, 3e-5)], ids=["single", "multi"])
def test_estimator_matches_jax(rng, n_spks, atol):
    """JAX-initialised trees through gradtts_from_jax; one row masked from
    frame 12 of 16."""
    tree = _jax_tree(n_spks)
    model = GradTTS(**dict(CFG, n_spks=n_spks)).eval()
    model.load_state_dict(gradtts_from_jax(tree, CFG["n_enc_layers"], n_spks), strict=True)
    b, t_y = 2, 16
    xt = rng.standard_normal((b, t_y, F)).astype(np.float32)
    mu = rng.standard_normal((b, t_y, F)).astype(np.float32)
    mask = np.ones((b, t_y), np.float32)
    mask[1, 12:] = 0
    t = np.array([0.3, 0.8], np.float32)
    spk = np.array([1, 2], np.int32) if n_spks > 1 else None
    jm = JGradTTS(**dict(CFG, n_spks=n_spks))
    out_j = jax.jit(functools.partial(jm.apply, method=JGradTTS.score))(
        {"params": tree}, jnp.asarray(xt), jnp.asarray(mask), jnp.asarray(mu), jnp.asarray(t),
        None if spk is None else jnp.asarray(spk))
    with torch.no_grad():
        out_t = model.score(_t(xt), _t(mask), _t(mu), _t(t),
                            None if spk is None else _t(spk, torch.long))
    assert np.abs(np.asarray(out_j)).max() > 0.1  # the attention and conv paths count
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=atol)


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("solver,steps", [("euler", 5), ("euler", 10), ("dpm", 6)])
def test_sampler_matches_jax(rng, solver, steps):
    model = _port_model(1)
    params = _to_jax(model)
    jm = JGradTTS(**CFG)
    b, t_y = 2, 16
    z = rng.standard_normal((b, t_y, F)).astype(np.float32)
    mu = rng.standard_normal((b, t_y, F)).astype(np.float32)
    mask = np.ones((b, t_y), np.float32)
    mask[1, 10:] = 0
    mask_j, mu_j = jnp.asarray(mask), jnp.asarray(mu)

    def score_j(xt, t):
        return jm.apply(params, xt, mask_j, mu_j, t, None, method=JGradTTS.score)

    def score_t(xt, t):
        return model.score(xt, _t(mask), _t(mu), t)

    args = (steps, CFG["beta_min"], CFG["beta_max"])
    if solver == "dpm":
        out_j = j_diff.reverse_diffusion_dpm(score_j, jnp.asarray(z), mask_j, mu_j, *args)
        with torch.no_grad():
            out_t = t_diff.reverse_diffusion_dpm(score_t, _t(z), _t(mask)[:, :, None],
                                                 _t(mu), *args)
    else:
        out_j = j_diff.reverse_diffusion(score_j, jnp.asarray(z), mask_j, mu_j, *args)
        with torch.no_grad():
            out_t = t_diff.reverse_diffusion(score_t, _t(z), _t(mask)[:, :, None], _t(mu),
                                             *args)
    _assert_close_to_scale(out_t.numpy(), np.asarray(out_j), 5e-5)


@pytest.mark.parametrize("solver", ["euler", "dpm"])
def test_synthesize_matches_jax_with_its_noise_replayed(rng, solver):
    """length_scale 0.91, temperature 1.5: y_lengths and attn equal, the
    decoder's output 5e-5; JAX's z draw replayed (grad_tts.py:201-202)."""
    model = _port_model(2)
    params = _to_jax(model)
    x, xl = _ids(rng, 11, [11, 7])
    key = jax.random.PRNGKey(7)
    kw = dict(temperature=1.5, length_scale=0.91, solver=solver)
    mu_j, dec_j, attn_j, yl_j = j_synthesize(JGradTTS(**CFG), params, jnp.asarray(x),
                                             jnp.asarray(xl), 10, 48, rng=key, **kw)
    rng_z, _ = jax.random.split(key)
    noise = np.asarray(jax.random.normal(rng_z, mu_j.shape, dtype=mu_j.dtype))
    with torch.no_grad():
        mu_t, dec_t, attn_t, yl_t = synthesize(model, _t(x, torch.long), _t(xl, torch.long),
                                               10, 48, noise=_t(noise), **kw)
    assert 1 < int(yl_t.min()) and int(yl_t.max()) < 48
    np.testing.assert_array_equal(yl_t.numpy(), np.asarray(yl_j))
    np.testing.assert_array_equal(attn_t.numpy(), np.asarray(attn_j))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0, atol=2e-5)
    _assert_close_to_scale(dec_t.numpy(), np.asarray(dec_j), 5e-5)


def test_duration_path_sums_exactly():
    """400 tokens of one frame each at length_scale 0.91: every 100 tokens
    the exact sum lands 1e-5 above an integer frame, where float32 sums
    round either way (torch's CPU sum gives 363.99997, its cumsum 364.0).
    The lengths and the path follow the exact sums, so that they do not
    depend on the device."""
    x_mask = torch.ones(2, 400)
    x_mask[1, 300:] = 0
    logw = torch.zeros(2, 400)
    w = np.float32(np.float32(1.0) * np.float32(0.91))
    exact = np.cumsum(np.where(x_mask.numpy() > 0, w, np.float32(0)).astype(np.float64), 1)
    y_lengths, y_mask, attn = duration_path(logw, x_mask, 0.91, 512)
    np.testing.assert_array_equal(y_lengths.numpy(), exact[:, -1].astype(np.int64))
    assert y_lengths.tolist() == [364, 273]
    pos = np.arange(512)
    below = (pos[None, None, :] < exact[:, :, None]).astype(np.float32)
    ref = (below - np.pad(below, ((0, 0), (1, 0), (0, 0)))[:, :-1])
    ref *= x_mask.numpy()[:, :, None] * y_mask.numpy()[:, None, :]
    np.testing.assert_array_equal(attn.numpy(), ref)
    assert attn.sum(1)[0, :364].eq(1).all() and attn.dtype == torch.float32


def test_stochastic_sampler_shape_and_mask(rng):
    """stoc=True: its per-step draws cannot match JAX's, so only the shape,
    the mask and finiteness are held; the DPM solver refuses it."""
    model = _port_model(3)
    x, xl = _ids(rng, 11, [11, 6])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _, dec, _, yl = synthesize(model, _t(x, torch.long), _t(xl, torch.long), 4, 48,
                                   stoc=True, generator=gen, length_scale=0.91)
        assert dec.shape == (2, 48, F) and torch.isfinite(dec).all()
        for i in range(2):
            assert dec[i, int(yl[i]):].abs().max() == 0
            assert dec[i, :int(yl[i])].abs().max() > 0
        with pytest.raises(ValueError, match="deterministic"):
            synthesize(model, _t(x, torch.long), _t(xl, torch.long), 4, 48, stoc=True,
                       solver="dpm")


# ---------------------------------------------------------------- lengths and the CLI


def test_jax_cli_cuts_lines_past_256_frames_and_the_port_does_not(rng):
    """The JAX CLI passes y_max_length = params.y_max_length_bucket (256,
    cli/inference.py:142-150) and synthesize clips y_lengths to it
    (grad_tts.py:193): a 301-token line, at least 0.91 x 301 > 256 frames,
    comes out 256 frames long. The port's synthesize keeps the clip; its CLI
    passes the covering multiple of 256, and the line keeps its length."""
    assert _jax_cli_params().y_max_length_bucket == 256
    with open(os.path.join(REPO, "cli", "inference.py")) as f:
        src = f.read()
    assert "bucket = params.y_max_length_bucket" in src and "y_max_length=bucket" in src
    model = _port_model(4)
    params = _to_jax(model)
    x, xl = _ids(rng, 301, [301])
    _, logw_j, xm_j = JGradTTS(**CFG).apply(params, jnp.asarray(x), jnp.asarray(xl),
                                            method=JGradTTS.encode)
    predicted = float(jnp.sum(jnp.ceil(jnp.exp(logw_j) * xm_j) * 0.91))
    assert predicted > 256
    _, _, _, yl_j = j_synthesize(JGradTTS(**CFG), params, jnp.asarray(x), jnp.asarray(xl), 1,
                                 256, length_scale=0.91)
    assert int(yl_j[0]) == 256  # cut
    with torch.no_grad():
        _, _, _, yl_t = synthesize(model, _t(x, torch.long), _t(xl, torch.long), 1, 256,
                                   length_scale=0.91)
        assert int(yl_t[0]) == 256  # the same clip, for parity
        mu_x, logw, x_mask = model.encode(_t(x, torch.long), _t(xl, torch.long))
        frames = float(durations(logw, x_mask, 0.91).sum())
        bucket = inference.covering_bucket(frames)
        assert bucket == 512 and abs(frames - predicted) < 1e-3
        _, _, _, yl_t = synthesize(model, _t(x, torch.long), _t(xl, torch.long), 1, bucket,
                                   length_scale=0.91)
    assert int(yl_t[0]) == int(frames) > 256  # not cut


TINY_CLI = dict(n_enc_channels=48, filter_channels=96, filter_channels_dp=64, n_enc_layers=2,
                n_feats=16, dec_dim=16)
TINY_HIFIGAN = dict(resblock="1", upsample_rates=[8, 8, 2, 2],
                    upsample_kernel_sizes=[16, 16, 4, 4], upsample_initial_channel=32,
                    resblock_kernel_sizes=[3, 7, 11],
                    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]], num_mels=16)
TEXTS = [
    "The quick brown fox jumps over the lazy dog while the curious cat watches from a "
    "sunlit windowsill in the early morning.",
    "Dr. Smith paid $3.50 for 2 tickets on Feb. 1st, 1999, at St. John's.",
    " ".join(["a long line keeps every frame of its predicted length"] * 3),
]


def _weight_norm_state_dict(sd):
    """A folded state_dict as a reference training checkpoint stores it:
    weight_v = 3 w, weight_g = ||w|| per output row, which fold back to w."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight"):
            p = k[: -len(".weight")]
            out[f"{p}.weight_g"] = v.norm(dim=tuple(range(1, v.dim())), keepdim=True)
            out[f"{p}.weight_v"] = 3 * v
        else:
            out[k] = v
    return out


def test_port_cli_on_cpu_writes_uncut_int16_wavs(tmp_path, monkeypatch):
    for k, v in TINY_CLI.items():
        monkeypatch.setattr(cfg, k, v)
    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    model.init_weights(torch.Generator().manual_seed(0))
    pt = str(tmp_path / "grad-tts.pt")
    torch.save(model.state_dict(), pt)
    npz = str(tmp_path / "grad-tts.npz")
    flat = {}

    def walk(node, pre):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, pre + [k])
            else:
                flat["/".join(pre + [k])] = np.asarray(v)

    walk(convert_gradtts(model.state_dict(), n_enc_layers=2), [])
    np.savez(npz, **flat)
    h = dict(TINY_HIFIGAN)
    voc = Generator(**{k: v for k, v in h.items() if k != "num_mels"}, n_mels=16)
    voc.init_weights(torch.Generator().manual_seed(1))
    hpt, hjson = str(tmp_path / "hifigan.pt"), str(tmp_path / "hifigan-config.json")
    torch.save({"generator": _weight_norm_state_dict(voc.state_dict())}, hpt)
    with open(hjson, "w") as f:
        json.dump(h, f)
    texts = str(tmp_path / "texts.txt")
    with open(texts, "w") as f:
        f.write("\n".join(TEXTS) + "\n")
    cmu = str(tmp_path / "cmu_dictionary")
    with open(cmu, "w", encoding="latin-1") as f:
        f.write(";;; a few words\nQUICK  K W IH1 K\nBROWN  B R AW1 N\nFOX  F AA1 K S\n")

    def run(ckpt, out, *extra):
        return inference.main(["-f", texts, "-c", ckpt, "--out-dir", str(tmp_path / out),
                               "--cmudict", cmu, "--device", "cpu", *extra])

    res = run(pt, "wav", "--hifigan", hpt, "--hifigan-config", hjson)
    assert res["n_params"] == sum(p.numel() for p in model.parameters())
    assert res["n_vocoder_params"] == sum(p.numel() for p in voc.parameters())
    assert len(res["samples"]) == 3
    for s in res["samples"]:
        sr, pcm = scipy.io.wavfile.read(s["path"])
        assert sr == cfg.sample_rate and pcm.dtype == np.int16
        assert pcm.shape == (s["frames"] * 256,)
        assert s["frames"] == int(s["predicted_frames"])  # nothing cut
        assert s["y_max_length"] % 256 == 0 and s["y_max_length"] >= s["frames"]
        assert np.isfinite(s["rtf"]) and s["rtf"] > 0
    long = res["samples"][2]
    assert long["frames"] > 256 and long["y_max_length"] == 256 * -(-long["frames"] // 256)

    # without a vocoder: mels; the .npz of JAX trees gives the same mels
    mels = [run(c, o, "--hifigan", str(tmp_path / "absent.pt"))["samples"]
            for c, o in ((pt, "mel_pt"), (npz, "mel_npz"))]
    for a, b, w in zip(*mels, res["samples"]):
        assert a["path"].endswith(f"{os.path.basename(w['path'])[:-4]}_mel.npy")
        ma, mb = np.load(a["path"]), np.load(b["path"])
        assert ma.shape == (w["frames"], 16)
        np.testing.assert_array_equal(ma, mb)


def test_port_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["-f", str(tmp_path / "t.txt"), "-c", str(tmp_path / "w.pt")])


def test_port_cli_refuses_unported_checkpoints(tmp_path):
    """An orbax directory stays refused; a ``.tpu_speech`` archive, as the
    JAX package's ``GradTTSTrainer.save_archive`` writes it, loads to the
    state_dict it was made from, bit for bit (``test_torch_tts_bf16.py``
    serves one)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        inference.load_gradtts_state_dict(str(tmp_path), 2, 1)
    from tpu_speech.utils.archive import save_archive

    model = _port_model(5)
    path = str(tmp_path / "model.tpu_speech")
    save_archive(path, {}, _to_jax(model)["params"])
    sd = inference.load_gradtts_state_dict(path, CFG["n_enc_layers"], 1)
    ref = model.state_dict()
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in ref)
