"""PyTorch port, featurizer: mel filterbank, K1's plain version and wrapper,
``filterbank_features`` and ``wav_to_spec`` against the JAX package.

Inputs come from numpy with a seed and go through both packages; JAX runs on
the CPU at 'highest' matmul precision (tests/conftest.py). On the CPU the K1
wrapper computes its plain version; the kernel itself is checked on the card
by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.audio import mel as jax_mel
from tpu_speech.models.spiral import features as jax_features
from tpu_speech.models.spiral import st2vec as jax_st2vec
from tpu_speech.ops.fused_logmel import logmel_reference
from tpu_speech_torch.audio import mel
from tpu_speech_torch.models.spiral import features
from tpu_speech_torch.models.spiral.st2vec import spiral_base_config, wav_to_spec
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops.fused_logmel import fused_logmel, logmel_plain, make_dft_mats

jax.config.update("jax_default_matmul_precision", "highest")


def _spiral_window():
    win = np.zeros(512, np.float32)
    win[96:416] = features.hann_window_symmetric(320)
    return win


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [
    (16000, 512, 128, 8000.0), (22050, 1024, 80, 8000.0), (16000, 512, 64, 7600.0),
])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, fmax):
    ours = mel.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax)
    ref = jax_mel.mel_filterbank(sr, n_fft, n_mels, 0.0, fmax)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(mel.hann_window(n_fft), jax_mel.hann_window(n_fft))
    np.testing.assert_array_equal(features.hann_window_symmetric(320),
                                  jax_features.hann_window_symmetric(320))


def test_make_dft_mats_matches_jax_unpadded():
    from tpu_speech.ops.fused_logmel import make_dft_mats as jax_make_dft_mats

    win = _spiral_window()
    fb = mel.mel_filterbank(16000, 512, 128, 0.0, 8000.0)
    dft, m = make_dft_mats(512, torch.tensor(win), torch.tensor(fb))
    ref_dft, ref_mel = jax_make_dft_mats(512, win, fb)
    # the JAX matrices pad the 257 bins to 384 for the TPU tiles
    np.testing.assert_allclose(dft[:, :257].numpy(), ref_dft[:, :257], atol=1e-7)
    np.testing.assert_allclose(dft[:, 257:].numpy(), ref_dft[:, 384:384 + 257], atol=1e-7)
    np.testing.assert_array_equal(m.numpy(), ref_mel[:257, :128])


@pytest.mark.parametrize("convention", ["spiral", "hifigan"])
def test_logmel_plain_matches_jax_reference(rng, convention):
    if convention == "spiral":
        n_fft, hop, win = 512, 160, _spiral_window()
        fb = mel.mel_filterbank(16000, 512, 128, 0.0, 8000.0)
        kw = {}
    else:
        n_fft, hop, win = 1024, 256, mel.hann_window(1024)
        fb = mel.mel_filterbank(22050, 1024, 80, 0.0, 8000.0)
        kw = dict(mag_mode="mag_eps", log_mode="clip", log_guard=1e-5)
    x = (rng.standard_normal((3, 20000)) * 0.1).astype(np.float32)
    t = 1 + (x.shape[1] - n_fft) // hop
    ref = logmel_reference(jnp.asarray(x), win, fb, n_fft=n_fft, hop_length=hop,
                           num_frames=t, **kw)
    out = logmel_plain(torch.tensor(x), torch.tensor(win), torch.tensor(fb),
                       n_fft=n_fft, hop_length=hop, num_frames=t, **kw)
    assert out.shape == (3, t, fb.shape[0])
    # the bound tests/test_fused_logmel.py uses for the kernel vs this oracle
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_fused_logmel_on_cpu_is_the_plain_version(rng):
    win, fb = torch.tensor(_spiral_window()), torch.tensor(
        mel.mel_filterbank(16000, 512, 128, 0.0, 8000.0))
    x = torch.tensor((rng.standard_normal((2, 6000)) * 0.1).astype(np.float32))
    before = dict(_build.LAUNCHES)
    # frames past the end of x read zeros, as in the JAX kernel
    for nf in (1, 16, 40):
        kw = dict(n_fft=512, hop_length=160, num_frames=nf)
        torch.testing.assert_close(fused_logmel(x, win, fb, **kw),
                                   logmel_plain(x, win, fb, **kw), rtol=0, atol=0)
    assert _build.LAUNCHES == before  # no kernel launch on a CPU tensor


def test_fused_logmel_rejects_what_it_does_not_take():
    win, fb = torch.ones(512), torch.ones(128, 257)
    x = torch.zeros(2, 4000)
    with pytest.raises(ValueError):
        fused_logmel(x, win, fb, n_fft=512, hop_length=160, num_frames=3, mag_mode="db")
    with pytest.raises(ValueError):
        fused_logmel(x[0], win, fb, n_fft=512, hop_length=160, num_frames=3)
    with pytest.raises(ValueError):
        fused_logmel(x, win[:300], fb, n_fft=512, hop_length=160, num_frames=3)
    with pytest.raises(ValueError):
        fused_logmel(x.to("meta"), win, fb, n_fft=512, hop_length=160, num_frames=3)


def _wavs(rng, b=3, n=16000):
    x = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    lens = np.array([n, int(n * 0.7), int(n * 0.33) + 7][:b], np.int32)
    for i, ln in enumerate(lens):
        x[i, ln:] = 0.0
    return x, lens


def test_filterbank_features_matches_jax_rfft_path(rng):
    x, lens = _wavs(rng)
    ref, ref_lens = jax_features.filterbank_features(
        jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=False)
    out, out_lens = features.filterbank_features(torch.tensor(x), torch.tensor(lens))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    assert out.shape == ref.shape and out.shape[1] % 16 == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_filterbank_features_matches_jax_pallas_interpret(rng):
    """Against the JAX featurizer running its fused Pallas log-mel kernel in
    interpret mode (the CPU default when the kernel is forced on)."""
    x, lens = _wavs(rng, b=2, n=12000)
    ref, _ = jax_features.filterbank_features(
        jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=True)
    out, _ = features.filterbank_features(torch.tensor(x), torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


def test_stft_input_is_the_jax_preprocessing(rng):
    x, _ = _wavs(rng, b=2, n=3000)
    ours = features.stft_input(torch.tensor(x), 512).numpy()
    xj = jax_features.normalize_time_domain(jnp.asarray(x))
    xj = jnp.concatenate([xj[:, :1], xj[:, 1:] - 0.97 * xj[:, :-1]], axis=1)
    ref = np.asarray(jnp.pad(xj, ((0, 0), (256, 256)), mode="reflect"))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_wav_to_spec_int16_wire_is_bit_exact(rng):
    cfg = spiral_base_config(num_features=32)
    pcm = (rng.standard_normal((2, 8000)) * 3000).clip(-32768, 32767).astype(np.int16)
    lens = np.array([8000, 5000], np.int32)
    from_int16, l16 = wav_to_spec(cfg, torch.tensor(pcm), torch.tensor(lens))
    # the host-side read_wav conversion of the same PCM
    from_f32, l32 = wav_to_spec(cfg, torch.tensor(pcm.astype(np.float32) / 32768.0),
                                torch.tensor(lens))
    torch.testing.assert_close(from_int16, from_f32, rtol=0, atol=0)
    torch.testing.assert_close(l16, l32, rtol=0, atol=0)
    jcfg = jax_st2vec.spiral_base_config(num_features=32)
    ref, _ = jax_st2vec.wav_to_spec(jcfg, jnp.asarray(pcm), jnp.asarray(lens))
    np.testing.assert_allclose(from_int16.numpy(), np.asarray(ref), atol=1e-4)


def test_wav_to_spec_mulaw_wire_matches_jax(rng):
    cfg = spiral_base_config(num_features=32)
    q = rng.integers(0, 256, size=(2, 6000), dtype=np.uint8)
    lens = np.array([6000, 4100], np.int32)
    out, _ = wav_to_spec(cfg, torch.tensor(q), torch.tensor(lens))
    ref, _ = jax_st2vec.wav_to_spec(jax_st2vec.spiral_base_config(num_features=32),
                                    jnp.asarray(q), jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_unported_featurizer_options_raise():
    x, lens = torch.zeros(1, 4000), torch.tensor([4000])
    with pytest.raises(NotImplementedError):
        features.filterbank_features(x, lens, normalize="per_feature_causal")
    with pytest.raises(NotImplementedError):
        features.filterbank_features(x, lens, mag_power=1.5)
    with pytest.raises(ValueError):
        features.filterbank_features(x, lens, training=True)  # dither, no generator
