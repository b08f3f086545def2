"""PyTorch port, ``models/spiral/augment.py`` against the JAX package on the
CPU: SpecAugment, SpecCutout and crop-or-pad with JAX's draws replayed (each
redrawn here from the JAX function's own key splits and handed to the port's
inner function), the port's own draws (ranges, the generator), the negative
cosine similarity loss and MFCC (the plain K1 path against JAX's rfft path).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral import augment as ja
from tpu_speech_torch.models.spiral import augment as pa

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(seed, b=3, t=57, f=20):
    return np.random.default_rng(seed).standard_normal((b, t, f)).astype(np.float32)


def _jax_band_draws(key, b, size, n, width):
    """``augment.py::spec_augment``'s band_mask draws."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (b, n), 0, max(size - width, 1))),
            np.asarray(jax.random.randint(k2, (b, n), 0, width + 1)))


@pytest.mark.parametrize("fm,tm,fw,tw", [(2, 2, 8, 10), (1, 3, 5, 30), (0, 2, 4, 6),
                                         (2, 0, 25, 6)])
def test_spec_augment_with_jax_draws_equals_jax(fm, tm, fw, tw):
    specs = _specs(fm * 10 + tm)
    key = jax.random.PRNGKey(fm + 7 * tm)
    want = ja.spec_augment(key, jnp.asarray(specs), freq_masks=fm, time_masks=tm,
                           freq_width=fw, time_width=tw, mask_value=-1.5)
    rng_f, rng_t = jax.random.split(key)
    b, t, f = specs.shape
    draws = (*_jax_band_draws(rng_f, b, f, fm, fw), *_jax_band_draws(rng_t, b, t, tm, tw))
    got = pa.apply_spec_augment(torch.tensor(specs), *map(torch.tensor, draws),
                                mask_value=-1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_cutout_with_jax_draws_equals_jax():
    specs = _specs(4)
    key = jax.random.PRNGKey(3)
    want = ja.spec_cutout(key, jnp.asarray(specs), rect_masks=4, rect_time=9, rect_freq=6)
    keys = jax.random.split(key, 4)
    b, t, f = specs.shape
    ts = jax.random.randint(keys[0], (b, 4), 0, t - 9)
    fs = jax.random.randint(keys[1], (b, 4), 0, f - 6)
    tw = jax.random.randint(keys[2], (b, 4), 0, 10)
    fw = jax.random.randint(keys[3], (b, 4), 0, 7)
    got = pa.apply_spec_cutout(torch.tensor(specs),
                               *(torch.tensor(np.asarray(a)) for a in (ts, fs, tw, fw)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length,random", [(40, True), (40, False), (57, True), (80, False)])
def test_crop_or_pad_equals_jax(length, random):
    specs = _specs(5)
    lens = np.array([57, 45, 12], np.int32)
    key = jax.random.PRNGKey(length) if random else None
    want, want_lens = ja.crop_or_pad_spectrogram(jnp.asarray(specs), jnp.asarray(lens), length,
                                                 rng=key)
    offsets = None
    if random and specs.shape[1] > length:
        offsets = torch.tensor(np.asarray(jax.random.randint(key, (3,), 0, 57 - length + 1)))
    got, got_lens = pa.crop_or_pad_at(torch.tensor(specs), torch.tensor(lens), length, offsets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def test_port_draws_come_from_the_generator_in_jax_ranges():
    specs = torch.tensor(_specs(6, b=64, t=120, f=40))
    a = pa.spec_augment(torch.Generator().manual_seed(1), specs, freq_width=8, time_width=10)
    b = pa.spec_augment(torch.Generator().manual_seed(1), specs, freq_width=8, time_width=10)
    c = pa.spec_augment(torch.Generator().manual_seed(2), specs, freq_width=8, time_width=10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    fs, fw, ts, tw = pa.spec_augment_draws(torch.Generator().manual_seed(3), (64, 120, 40),
                                           freq_width=8, time_width=10)
    assert fs.shape == (64, 2) and int(fs.max()) <= 40 - 8 - 1 and int(fw.max()) <= 8
    assert int(ts.max()) <= 120 - 10 - 1 and int(tw.max()) <= 10 and int(tw.min()) >= 0
    masked = (a == 0).float()
    assert 0 < float(masked.mean()) < 0.5
    cut = pa.spec_cutout(torch.Generator().manual_seed(4), specs)
    assert cut.shape == specs.shape and bool((cut == 0).any())
    cropped, lens = pa.crop_or_pad_spectrogram(specs, torch.full((64,), 120), 100,
                                               generator=torch.Generator().manual_seed(5))
    assert cropped.shape == (64, 100, 40) and int(lens.max()) == 100
    starts = [int(torch.nonzero((specs[i] == cropped[i][0]).all(-1))[0]) for i in range(64)]
    assert min(starts) >= 0 and max(starts) <= 20 and len(set(starts)) > 1


@pytest.mark.parametrize("masked", [False, True])
def test_negative_cosine_similarity_loss_matches_jax(masked):
    r = np.random.default_rng(8)
    preds = r.standard_normal((3, 11, 16)).astype(np.float32)
    targets = r.standard_normal((3, 11, 16)).astype(np.float32)
    preds[0, 3] = 0.0  # a zero row: the 1e-8 floor of the norms
    valid = (r.random((3, 11)) < 0.6).astype(np.float32) if masked else None
    want = ja.negative_cosine_similarity_loss(
        jnp.asarray(preds), jnp.asarray(targets), None if valid is None else jnp.asarray(valid))
    got = pa.negative_cosine_similarity_loss(
        torch.tensor(preds), torch.tensor(targets), None if valid is None else torch.tensor(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)
    assert float(pa.negative_cosine_similarity_loss(torch.tensor(preds[1:]),
                                                    torch.tensor(preds[1:]))) == pytest.approx(-1)


@pytest.mark.parametrize("n_mfcc,nfilt,window", [(13, 40, 0.02), (20, 64, 0.025)])
def test_mfcc_matches_jax(n_mfcc, nfilt, window):
    """The port's plain K1 path on the CPU against JAX's rfft path, DCT-II of
    the unnormalized log-mel: within 1e-5 x max(1, max|JAX|)."""
    r = np.random.default_rng(nfilt)
    wavs = (0.2 * r.standard_normal((2, 4000))).astype(np.float32)
    wavs[1, 2500:] = 0.0
    lens = np.array([4000, 2500], np.int32)
    kw = dict(n_mfcc=n_mfcc, nfilt=nfilt, window_size=window, dither=0.0)
    want, want_lens = ja.mfcc_features(jnp.asarray(wavs), jnp.asarray(lens), **kw)
    got, got_lens = pa.mfcc_features(torch.tensor(wavs), torch.tensor(lens), **kw)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
