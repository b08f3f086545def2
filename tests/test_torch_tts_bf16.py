"""PyTorch port, bf16 Grad-TTS + HiFi-GAN serving and ``.tpu_speech``
archives in ``-c``: the port against the JAX package.

bf16 serving is JAX's ``bench.py::_cast_bf16`` / ``cli/export_tts.py``: every
floating parameter cast to bf16, the activations following
(``utils/precision.py::cast_params_bf16`` casts the parameters and no
buffer). At ``tests/test_torch_gradtts.py``'s small config, weights carried by
``convert_gradtts``. Each stage's dtype is held to JAX's first; then the
values under the 2x rule: with R the JAX fp32 run, J JAX's bf16 run and P the
port's, max|P - R| <= 2 max|J - R| + 1e-3 max(1, max|R|) (the floor is a
fraction of one bf16 step at the output's scale). The fp32 and bf16 runs
share one draw: JAX's float32 normal, rounded to bf16 for the bf16 runs (a
bf16 ``jax.random.normal`` is another sample, which would make R and J
differ by the noise, not by the rounding).

The duration path is the one stage the port computes otherwise: JAX's bf16
``w_ceil`` and its cumsum are bf16, and the path it makes is not exact
(``test_bf16_duration_path``); the port keeps exact lengths and path, so the
value tests replay JAX's bf16 path (``synthesize(path=...)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_speech.compat.torch_gradtts import convert_gradtts
from tpu_speech.compat.torch_hifigan import convert_generator
from tpu_speech.models import diffusion as j_diff
from tpu_speech.models.grad_tts import GradTTS as JGradTTS
from tpu_speech.models.grad_tts import synthesize as j_synthesize
from tpu_speech.models.hifigan import Generator as JGenerator
from tpu_speech.ops import masks as j_masks
from tpu_speech.utils.archive import save_archive as j_save_archive
from tpu_speech_torch.cli import inference
from tpu_speech_torch.models.grad_tts import GradTTS, duration_path, synthesize
from tpu_speech_torch.models.hifigan import Generator
from tpu_speech_torch.utils.precision import cast_params_bf16

jax.config.update("jax_default_matmul_precision", "highest")

CFG = dict(
    n_vocab=50, n_spks=1, spk_emb_dim=16, n_enc_channels=48, filter_channels=96,
    filter_channels_dp=64, n_heads=2, n_enc_layers=2, enc_kernel=3, enc_dropout=0.1,
    window_size=4, n_feats=16, dec_dim=16, beta_min=0.05, beta_max=20.0, pe_scale=1000.0,
)
F = CFG["n_feats"]
VOC = dict(resblock="1", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
BF = jnp.bfloat16
TWICE_FLOOR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores (a step that takes 0.5 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cast(tree):
    """JAX's bf16 serving cast (``cli/export_tts.py::_cast_bf16``)."""
    return jax.tree.map(lambda p: p.astype(BF) if jnp.issubdtype(p.dtype, jnp.floating) else p,
                        tree)


def _models(seed=2):
    model = GradTTS(**CFG).init_weights(torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # the rezero gains away from 0: the attention moves the score
        for n, p in model.named_parameters():
            if n.endswith(".g"):
                p.fill_(0.015)
    params = jax.tree.map(jnp.asarray, convert_gradtts(
        model.state_dict(), n_spks=1, n_enc_layers=CFG["n_enc_layers"]))
    return model, params


def _ids(rng):
    x = rng.integers(1, CFG["n_vocab"], size=(2, 11)).astype(np.int32)
    return x, np.array([11, 7], np.int32)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_within_twice(port, jax_bf16, ref):
    """The 2x rule on arrays: max|P - R| <= 2 max|J - R| + floor."""
    err_p = float(np.abs(port - ref).max())
    err_j = float(np.abs(jax_bf16 - ref).max())
    assert err_p <= 2 * err_j + TWICE_FLOOR * max(1.0, float(np.abs(ref).max())), (err_p, err_j)
    return err_p, err_j


def _jax_path(jm, params, x, xl, length_scale, y_max):
    """JAX's encoder and duration path (``grad_tts.py:186-197``): (mu_x,
    logw, x_mask, w_ceil, y_lengths, y_mask, attn)."""
    mu_x, logw, x_mask = jm.apply(params, jnp.asarray(x), jnp.asarray(xl), None,
                                  method=JGradTTS.encode)
    w_ceil = jnp.ceil(jnp.exp(logw) * x_mask) * length_scale
    y_lengths = jnp.clip(jnp.sum(w_ceil, axis=1), 1, y_max).astype(jnp.int32)
    y_mask = j_masks.sequence_mask(y_lengths, y_max).astype(mu_x.dtype)
    attn = j_masks.generate_path(w_ceil, x_mask[:, :, None] * y_mask[:, None, :])
    return mu_x, logw, x_mask, w_ceil, y_lengths, y_mask, attn


def _jax_after_path(jm, params, mu_x, y_mask, attn, noise, temperature, n, solver):
    """``synthesize`` after its duration path (``grad_tts.py:199-224``),
    the draw given: (mu_y, z, score at t = 1, dec)."""
    mu_y = jnp.einsum("bxy,bxf->byf", attn.astype(mu_x.dtype), mu_x)
    z = mu_y + noise.astype(mu_y.dtype) / temperature

    def score_fn(xt, t):
        return jm.apply(params, xt, y_mask, mu_y, t, None, method=JGradTTS.score)

    score = score_fn(z, jnp.ones((z.shape[0],), z.dtype))
    if solver == "dpm":
        dec = j_diff.reverse_diffusion_dpm(score_fn, z, y_mask, mu_y, n, jm.beta_min,
                                           jm.beta_max)
    else:
        dec = j_diff.reverse_diffusion(score_fn, z, y_mask, mu_y, n, jm.beta_min, jm.beta_max)
    return mu_y, z, score, dec


# ---------------------------------------------------------------- dtypes, stage by stage


def test_stage_dtypes_equal_jax(rng):
    """On bf16 parameters every stage has JAX's dtype: the embedding and the
    encoder's outputs, the alignment and mask, mu_y, z, the score, each
    sampler's output (Euler and DPM), the HiFi-GAN wav; the lengths int32.
    The one stage that differs by design: the durations, float64 in the
    port (exact sums), bf16 in JAX. Buffers stay float32 (none here)."""
    model, params = _models()
    pb, mb = _cast(params), cast_params_bf16(model)
    assert all(p.dtype == torch.bfloat16 for p in mb.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    jm = JGradTTS(**CFG)
    x, xl = _ids(rng)
    mu_x, logw, x_mask, w_ceil, y_lengths, y_mask, attn = _jax_path(jm, pb, x, xl, 0.91, 48)
    noise = jax.random.normal(jax.random.PRNGKey(0), (2, 48, F)).astype(BF)
    jax_dt = {"mu_x": mu_x.dtype, "logw": logw.dtype, "x_mask": x_mask.dtype,
              "y_mask": y_mask.dtype, "attn": attn.dtype}
    for solver in ("euler", "dpm"):
        mu_y, z, score, dec = _jax_after_path(jm, pb, mu_x, y_mask, attn, noise, 1.5, 3, solver)
        jax_dt.update(mu_y=mu_y.dtype, z=z.dtype, score=score.dtype, **{solver: dec.dtype})
    assert w_ceil.dtype == BF and y_lengths.dtype == jnp.int32

    with torch.no_grad():
        xt, xlt = _t(x, torch.long), _t(xl, torch.long)
        emb_p = mb.encoder.emb(xt)
        mu_p, logw_p, xm_p = mb.encode(xt, xlt)
        yl_p, ym_p, attn_p = duration_path(logw_p, xm_p, 0.91, 48)
        mu_y_p = torch.matmul(attn_p.transpose(1, 2), mu_p)
        z_p = mu_y_p + _t(_f32(noise)).to(torch.bfloat16) / 1.5
        score_p = mb.score(z_p, ym_p, mu_y_p, torch.ones(2, dtype=torch.bfloat16))
        port_dt = {"mu_x": mu_p.dtype, "logw": logw_p.dtype, "x_mask": xm_p.dtype,
                   "y_mask": ym_p.dtype, "attn": attn_p.dtype, "mu_y": mu_y_p.dtype,
                   "z": z_p.dtype, "score": score_p.dtype}
        for solver in ("euler", "dpm"):
            out = synthesize(mb, xt, xlt, 3, 48, temperature=1.5, length_scale=0.91,
                             solver=solver, noise=_t(_f32(noise)).to(torch.bfloat16))
            assert out[0].dtype == out[2].dtype == torch.bfloat16
            port_dt[solver] = out[1].dtype
            assert out[3].dtype == torch.int32
    assert emb_p.dtype == torch.bfloat16
    assert yl_p.dtype == torch.int32
    assert {k: str(v).replace("torch.", "") for k, v in port_dt.items()} == {
        k: str(np.dtype(v)) for k, v in jax_dt.items()}
    # the vocoder: bf16 weights, a bf16 mel in, bf16 out (float32 after the
    # export's cast, cli/export_tts.py:80-83)
    gen, jparams = _vocoders()
    mel = rng.standard_normal((1, 9, F)).astype(np.float32)
    wav_j = JGenerator(**VOC).apply(_cast(jparams), jnp.asarray(mel).astype(BF))
    with torch.no_grad():
        wav_p = cast_params_bf16(gen)(_t(mel).to(torch.bfloat16).transpose(1, 2))
    assert str(wav_p.dtype).replace("torch.", "") == str(np.dtype(wav_j.dtype)) == "bfloat16"


# ---------------------------------------------------------------- the duration path


def test_bf16_duration_path():
    """400 tokens of one frame each at length_scale 0.91, logw in bf16. JAX
    (``grad_tts.py:190-197``): w_ceil is bf16 (0.91 rounds to 0.91015625),
    and ``generate_path``'s cumsum runs in bf16, whose boundaries past 256
    frames are even numbers: the path gives tokens 0, 2 or 3 frames where
    the exact path gives 0 or 1, though the lengths (its float32 sum) are
    exact here. The port's path on the same bf16 logw is the exact one,
    with the exact lengths, in bf16 (ROADMAP Queue 3)."""
    logw = jnp.zeros((1, 400), BF)
    x_mask = jnp.ones((1, 400), BF)
    w_ceil = jnp.ceil(jnp.exp(logw) * x_mask) * 0.91
    assert w_ceil.dtype == BF and float(w_ceil[0, 0]) == 0.91015625
    y_lengths = jnp.clip(jnp.sum(w_ceil, axis=1), 1, 512).astype(jnp.int32)
    y_mask = j_masks.sequence_mask(y_lengths, 512).astype(BF)
    attn_j = _f32(j_masks.generate_path(w_ceil, x_mask[:, :, None] * y_mask[:, None, :]))
    cum_j = _f32(jnp.cumsum(w_ceil, axis=1))[0]
    assert np.all(cum_j[cum_j > 256] % 2 == 0)
    frames_j = attn_j.sum(-1)[0]
    assert frames_j.max() >= 2 and (frames_j == 0).sum() > 40

    exact = np.cumsum(np.full(400, np.float32(0.91), np.float64))
    pos = np.arange(512)
    below = (pos[None, :] < exact[:, None]).astype(np.float32)
    ref = (below - np.pad(below, ((1, 0), (0, 0)))[:-1]) * (pos < int(exact[-1]))
    assert int(y_lengths[0]) == int(exact[-1]) == 364
    yl_p, ym_p, attn_p = duration_path(_t(_f32(logw)).to(torch.bfloat16),
                                       _t(_f32(x_mask)).to(torch.bfloat16), 0.91, 512)
    assert yl_p.tolist() == [364] and attn_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(attn_p[0].float().numpy(), ref)
    assert set(attn_p.float().sum(-1)[0].tolist()) == {0.0, 1.0}
    assert (attn_p[0].float().numpy() != attn_j[0]).any()


# ---------------------------------------------------------------- values


@pytest.mark.parametrize("solver,steps", [("euler", 10), ("dpm", 6)])
def test_bf16_synthesize_within_twice_the_jax_bf16_error(rng, solver, steps):
    """``synthesize`` on bf16 parameters, JAX's bf16 path and draw replayed,
    against JAX's fp32 run on the same path and draw: mu_y and the decoder's
    mel under the 2x rule, JAX's bf16 run the yardstick."""
    model, params = _models()
    jm = JGradTTS(**CFG)
    x, xl = _ids(rng)
    pb = _cast(params)
    _, _, _, _, y_lengths, _, attn = _jax_path(jm, pb, x, xl, 0.91, 48)
    assert 1 < int(y_lengths.min()) and int(y_lengths.max()) < 48
    noise = jax.random.normal(jax.random.PRNGKey(7), (2, 48, F))
    runs = {}
    for bf16, p in ((False, params), (True, pb)):
        mu_x, _, _, _, _, _, _ = _jax_path(jm, p, x, xl, 0.91, 48)
        y_mask = j_masks.sequence_mask(y_lengths, 48).astype(mu_x.dtype)
        mu_y, _, _, dec = _jax_after_path(jm, p, mu_x, y_mask, attn, noise, 1.5, steps, solver)
        runs[bf16] = (_f32(mu_y), _f32(dec))
    with torch.no_grad():
        mu_p, dec_p, _, yl_p = synthesize(
            cast_params_bf16(model), _t(x, torch.long), _t(xl, torch.long), steps, 48,
            temperature=1.5, length_scale=0.91, solver=solver,
            noise=_t(_f32(noise.astype(BF))).to(torch.bfloat16),
            path=(_t(y_lengths), _t(_f32(attn)).to(torch.bfloat16)))
    assert dec_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(yl_p.numpy(), np.asarray(y_lengths))
    (mu32, dec32), (mu16, dec16) = runs[False], runs[True]
    _assert_within_twice(mu_p.float().numpy(), mu16, mu32)
    err_p, err_j = _assert_within_twice(dec_p.float().numpy(), dec16, dec32)
    assert err_j > 0  # the yardstick is bf16 rounding, not zero


def _vocoders(seed=3):
    """The port's generator (weights uniform in +-1/sqrt(fan_in): outputs of
    order one) and its JAX tree."""
    gen = Generator(**VOC, n_mels=F).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(m.weight)
                for p in (m.weight, m.bias):
                    p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * fan_in ** -0.5)
    params = convert_generator(gen.state_dict(), VOC["upsample_rates"],
                               VOC["resblock_kernel_sizes"], VOC["resblock"])
    return gen, jax.tree.map(jnp.asarray, params)


def test_bf16_hifigan_within_twice_the_jax_bf16_error(rng):
    """The generator on bf16 parameters and a bf16 mel, float32 out (the
    export's ``cli/export_tts.py:80-83``), under the 2x rule against JAX's
    fp32 generator on the same mel."""
    gen, params = _vocoders()
    mel = (rng.standard_normal((2, 23, F)) * 0.5).astype(np.float32)
    jg = JGenerator(**VOC)
    ref = _f32(jg.apply(params, jnp.asarray(mel)))
    j16 = _f32(jg.apply(_cast(params), jnp.asarray(mel).astype(BF)))
    with torch.no_grad():
        wav = cast_params_bf16(gen)(_t(mel).to(torch.bfloat16).transpose(1, 2)).float()[:, 0]
    assert wav.dtype == torch.float32 and np.abs(ref).max() > 0.1
    _assert_within_twice(wav.numpy(), j16, ref)


# ---------------------------------------------------------------- archives in -c


def test_jax_archive_serves(tmp_path, rng):
    """A ``.tpu_speech`` archive as ``GradTTSTrainer.save_archive`` writes it
    (``train/gradtts.py:153-164``: the config and ``params["params"]``
    through ``utils/archive.py::save_archive``) loads through the CLI's
    ``load_gradtts_state_dict``, leaf for leaf the JAX tree, and serves:
    ``synthesize`` within 5e-5 x max(1, max|JAX|) of JAX's on the same tree,
    its draw replayed."""
    model, params = _models(seed=4)
    path = str(tmp_path / "gradtts.tpu_speech")
    j_save_archive(path, {"n_feats": F}, jax.device_get(params["params"]))
    sd = inference.load_gradtts_state_dict(path, CFG["n_enc_layers"], 1)
    ref_sd = model.state_dict()
    assert sd.keys() == ref_sd.keys()
    assert all(torch.equal(sd[k], ref_sd[k]) for k in sd)
    served = GradTTS(**CFG).eval()
    served.load_state_dict(sd)
    x, xl = _ids(rng)
    key = jax.random.PRNGKey(9)
    mu_j, dec_j, attn_j, yl_j = j_synthesize(JGradTTS(**CFG), params, jnp.asarray(x),
                                             jnp.asarray(xl), 10, 48, temperature=1.5,
                                             length_scale=0.91, rng=key)
    rng_z, _ = jax.random.split(key)
    noise = np.asarray(jax.random.normal(rng_z, mu_j.shape, dtype=mu_j.dtype))
    with torch.no_grad():
        _, dec_t, _, yl_t = synthesize(served, _t(x, torch.long), _t(xl, torch.long), 10, 48,
                                       temperature=1.5, length_scale=0.91, noise=_t(noise))
    np.testing.assert_array_equal(yl_t.numpy(), np.asarray(yl_j))
    ref = np.asarray(dec_j)
    assert np.abs(dec_t.numpy() - ref).max() <= 5e-5 * max(1.0, np.abs(ref).max())
