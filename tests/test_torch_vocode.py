"""PyTorch port, mel inversion: ``audio/vocode.py`` against the JAX package's
``tpu_speech/audio/vocode.py`` on the same numpy inputs.

The STFT and the inverse STFT are held sample by sample (1e-4); so are the
zero-phase start and the first two momentum Griffin-Lim iterations. The
angle update s / sqrt(max(|s|^2, 1e-8)) with momentum 0.99 amplifies FFT
rounding from one iteration to the next, so the 32-iteration outputs are
held by spectral convergence (the distance of their magnitude STFT from the
pseudo-inverted target, relative to the target), not sample by sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_speech.audio import vocode as j_voc
from tpu_speech.audio.mel import hann_window as j_hann
from tpu_speech.audio.mel import mel_spectrogram_np as j_mel
from tpu_speech_torch.audio import vocode as t_voc


def _speech_like(rng, n, sr=22050):
    t = np.arange(n) / sr
    f0 = 140 * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum(np.sin(h * phase + rng.uniform(0, 6)) / h for h in range(1, 20))
    y *= 0.5 * (1 + np.sin(2 * np.pi * 4 * t)) ** 2
    return (0.2 * y / np.abs(y).max() + 0.002 * rng.standard_normal(n)).astype(np.float32)


def _spectral_convergence(wav, log_mel):
    """||S - |STFT(wav)||| / ||S||, S the pseudo-inverted magnitude that
    Griffin-Lim aims at (float64, numpy)."""
    inv = j_voc.mel_pseudo_inverse(22050, 1024, 80).astype(np.float64)
    target = np.exp(log_mel.astype(np.float64)) @ inv.T
    mag = np.abs(np.asarray(j_voc.stft_complex(jnp.asarray(wav), 1024, 256,
                                               jnp.asarray(j_hann(1024)))))
    return float(np.linalg.norm(mag - target) / np.linalg.norm(target))


def test_pseudo_inverse_and_window_equal_jax():
    inv, window = t_voc.griffin_lim_constants(22050, 1024, 80, torch.device("cpu"))
    np.testing.assert_array_equal(inv.numpy(), j_voc.mel_pseudo_inverse(22050, 1024, 80).T)
    np.testing.assert_array_equal(window.numpy(), j_hann(1024))
    again = t_voc.griffin_lim_constants(22050, 1024, 80, torch.device("cpu"))
    assert again[0] is inv and again[1] is window  # built once


@pytest.mark.parametrize("n_fft,hop,n", [(1024, 256, 256 * 40), (1024, 256, 256 * 23 + 7),
                                         (800, 200, 200 * 31)],
                         ids=["griffin_lim", "ragged", "hop_200"])
def test_stft_and_istft_match_jax(rng, n_fft, hop, n):
    """STFT and the block-sum overlap-add, 1e-4 sample by sample; an n_fft
    that is not a multiple of hop raises (no caller has one)."""
    y = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    window = j_hann(n_fft)
    spec_j = j_voc.stft_complex(jnp.asarray(y), n_fft, hop, jnp.asarray(window))
    spec_t = t_voc.stft_complex(torch.from_numpy(y), n_fft, hop, torch.from_numpy(window))
    assert spec_t.dtype == torch.complex64 and spec_t.shape == spec_j.shape
    np.testing.assert_allclose(spec_t.numpy(), np.asarray(spec_j), rtol=0, atol=1e-4)
    for length in (None, n - 5):
        back_j = np.asarray(j_voc.istft(spec_j, n_fft, hop, jnp.asarray(window), length))
        back_t = t_voc.istft(torch.from_numpy(np.asarray(spec_j)), n_fft, hop,
                             torch.from_numpy(window), length).numpy()
        assert back_t.shape == back_j.shape
        np.testing.assert_allclose(back_t, back_j, rtol=0, atol=1e-4)
    # a round trip: the centred frames cover hop x (frames - 1) samples
    np.testing.assert_allclose(back_t, y[:, :back_t.shape[1]], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of hop"):
        t_voc.istft(torch.from_numpy(np.asarray(spec_j)), n_fft, hop + 1,
                    torch.from_numpy(window))


@pytest.mark.parametrize("n_iters", [0, 1, 2])
def test_griffin_lim_first_iterations_match_jax(rng, n_iters):
    """The zero-phase start and one or two momentum iterations, 1e-4 sample
    by sample, on the mel of a speech-like wav (max |wav| 0.25-0.32; the
    distance grows 3e-8, 1e-5, 8e-5 over iterations 0-2)."""
    mel = j_mel(_speech_like(rng, 256 * 60)[None])
    want = np.asarray(j_voc.fast_griffin_lim(jnp.asarray(mel), n_iters=n_iters))
    got = t_voc.fast_griffin_lim(torch.from_numpy(mel), n_iters=n_iters).numpy()
    assert got.shape == want.shape == (1, 256 * (mel.shape[1] - 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_griffin_lim_32_iterations_by_spectral_convergence(rng):
    """32 iterations: both outputs' spectral convergence within 1e-4 of each
    other (measured 6e-6, at 0.18 from the start's 0.94), the port's below
    the start's; the sample-by-sample distance, 8.7e-3 at a max |wav| of
    0.25 (momentum 0.99 amplifies the FFTs' rounding), is only bounded."""
    mel = j_mel(_speech_like(rng, 256 * 60)[None])
    want = np.asarray(j_voc.fast_griffin_lim(jnp.asarray(mel), n_iters=32))
    got = t_voc.fast_griffin_lim(torch.from_numpy(mel), n_iters=32).numpy()
    start = t_voc.fast_griffin_lim(torch.from_numpy(mel), n_iters=0).numpy()
    sc_j, sc_t, sc_0 = (_spectral_convergence(w, mel) for w in (want, got, start))
    assert abs(sc_t - sc_j) < 1e-4, (sc_t, sc_j)
    assert sc_t < 0.25 * sc_0, (sc_t, sc_0)
    assert np.abs(got - want).max() < 0.1 * np.abs(want).max()
