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
from tpu_speech_torch.ops import fused_logmel as fused_logmel_ops
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


@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024, 2048])
def test_fft_tables_are_float64_twiddles(n_fft):
    tab = fused_logmel_ops.fft_tables(n_fft, torch.device("cpu"))
    a = fused_logmel_ops.twiddle_exponents(n_fft)
    m, v = n_fft // 2, n_fft // 64
    assert tab.dtype == torch.float64 and tab.shape == (m + m // 2 + v // 2 + 16, 2)
    ref = np.exp(-2j * np.pi * a / n_fft)
    np.testing.assert_allclose(tab[:, 0].numpy(), ref.real, rtol=0, atol=1e-15)
    np.testing.assert_allclose(tab[:, 1].numpy(), ref.imag, rtol=0, atol=1e-15)
    # the W_V and W_32 entries the transform's stages read
    split = m + m // 2
    np.testing.assert_array_equal(a[split:split + v // 2], np.arange(v // 2) * (n_fft // v))
    np.testing.assert_array_equal(a[split + v // 2:], np.arange(16) * (n_fft // 32))


def _kernel_power(frames, n_fft):
    """csrc/fused_logmel.cu's transform step for step, in float64 numpy over
    the wrapper's tables: r[:, l, p] is lane l's register p; returns the
    power of bins 0..n_fft/2."""
    br = fused_logmel_ops._bitrev
    w = fused_logmel_ops.fft_tables(n_fft, torch.device("cpu")).numpy()
    w = w[:, 0] + 1j * w[:, 1]
    m = n_fft // 2
    v = m // 32
    h, logv = v // 2, v.bit_length() - 1
    tw1, tw2 = w[:m].reshape(v, 32).T, w[m:m + m // 2].reshape(h, 32).T
    wv, w32 = w[m + m // 2:m + m // 2 + h], w[m + m // 2 + h:]
    lane = np.arange(32)
    r = (frames[:, 0::2] + 1j * frames[:, 1::2]).reshape(-1, v, 32).transpose(0, 2, 1)
    for st in range(logv):  # V-point DFTs in registers, radix 2, DIF
        s = v >> (st + 1)
        for j in range(h):
            i = j % s
            a = (j // s) * 2 * s + i
            c = a + s
            r[:, :, a], r[:, :, c] = (r[:, :, a] + r[:, :, c],
                                      (r[:, :, a] - r[:, :, c]) * wv[i * (v // (2 * s))])
    r = r * tw1
    for q in range(5):  # across the lanes: transposing exchanges
        d = 16 >> q
        up = ((lane & d) != 0)[:, None]
        sent = np.where(up, r[:, :, :h], r[:, :, h:])
        kept = np.where(up, r[:, :, h:], r[:, :, :h])
        recv = sent[:, lane ^ d]
        ws = np.where(lane & d, -1, 1) * w32[(lane & (d - 1)) * (16 // d)]
        r = np.concatenate([kept + recv, (kept - recv) * ws[:, None]], axis=2)
    l4, b4 = lane >> 4, br(lane & 15, 4)
    src0 = np.where(l4 == 1, lane ^ 15, np.where(b4 == 0, lane, br((16 - b4) & 15, 4)))
    power = np.empty((frames.shape[0], m + 1))
    for a in range(h):  # the real split, one pair (k, M - k) per register
        a1 = br(h - 1 - br(a, logv - 1), logv - 1)
        a0 = br((h - br(a, logv - 1)) % h, logv - 1)
        if a == 0:
            sent = np.where(l4 == 1, r[:, :, h + a1], np.where(b4 == 0, r[:, :, 0], r[:, :, h]))
            partner = sent[:, src0]
        else:
            partner = np.where(l4 == 1, r[:, :, h + a1], r[:, :, h + a0])[:, lane ^ 15]
        e, o = (r[:, :, a] + np.conj(partner)) / 2, (r[:, :, a] - np.conj(partner)) / 2j
        k = l4 + 2 * br(a, logv - 1) + v * b4
        power[:, k] = np.abs(e + tw2[:, a] * o) ** 2
        power[:, m - k] = np.abs(e - tw2[:, a] * o) ** 2
    power[:, m // 2] = np.abs(r[:, 0, h]) ** 2
    return power


@pytest.mark.parametrize("n_fft", [128, 256, 512, 1024, 2048])
def test_kernel_transform_over_the_tables_is_the_rfft(rng, n_fft):
    frames = rng.standard_normal((5, n_fft))
    ref = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    np.testing.assert_allclose(_kernel_power(frames, n_fft), ref, rtol=0,
                               atol=1e-12 * ref.max())


def _band_check(fb):
    bands = fused_logmel_ops.mel_bands(torch.tensor(fb)).numpy()
    assert bands.dtype == np.int32 and bands.shape == (2, fb.shape[0])
    for m, (lo, hi) in enumerate(bands.T):
        nz = np.flatnonzero(fb[m])
        if nz.size == 0:
            assert lo == hi == 0
        else:
            assert (lo, hi) == (nz[0], nz[-1] + 1)  # covers every nonzero, tightly
    return bands


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 512, 128), (22050, 1024, 80),
                                              (16000, 128, 40)])
def test_mel_bands_cover_every_nonzero(sr, n_fft, n_mels):
    fb = np.array(mel.mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2))
    fb[3] = 0.0  # an all-zero filter
    bands = _band_check(fb)
    assert bands[0, 3] == bands[1, 3] == 0
    # the banded product is the dense one
    p = np.random.default_rng(n_fft).random((4, n_fft // 2 + 1)).astype(np.float32)
    banded = np.stack([p[:, lo:hi] @ fb[m, lo:hi] for m, (lo, hi) in enumerate(bands.T)], 1)
    np.testing.assert_allclose(banded, p @ fb.T, rtol=1e-6, atol=0)


def _staged_frames(x, n_fft, hop, tf, t0):
    """The FFT kernel's staging of one tile (frames t0 .. t0 + tf - 1), index
    for index: the span at stride hop, or each frame on its own at stride
    n_fft where hop is odd or >= n_fft; the frames it then reads."""
    fs = hop if hop % 2 == 0 and hop < n_fft else n_fft
    span = ((tf - 1) * fs + n_fft + 3) & ~3
    start, avail = t0 * hop, x.shape[0] - t0 * hop
    wav = np.zeros(span, x.dtype)
    for i in range(span):
        f = i // fs
        src = i if fs == hop else f * hop + (i - f * fs)
        if (fs == hop or f < tf) and src < avail:
            wav[i] = x[start + src]
    return np.stack([wav[f * fs:f * fs + n_fft] for f in range(tf)])


def test_kernel_launch_config_takes_powers_of_two_only():
    """The FFT takes the powers of two 128-2048 at any hop, the direct DFT
    every other n_fft up to 8192; both fit in shared memory (the FFT two
    blocks an SM at hop 256). The FFT's staging reads every frame right at
    odd, non-multiple-of-4 and larger-than-n_fft hops."""
    for n_fft in (128, 256, 512, 1024, 2048):
        tf, smem = fused_logmel_ops.kernel_launch_config(n_fft, 256, 40)
        assert 2 * smem <= 232448 and tf >= 8  # two blocks fit an SM
        assert fused_logmel_ops.kernel_transform(n_fft) == "fft"
    for n_fft in (400, 320, 321, 64, 4096):
        tf, smem = fused_logmel_ops.kernel_launch_config(n_fft, 160, min(40, n_fft // 2 + 1))
        assert fused_logmel_ops.kernel_transform(n_fft) == "dft"
        assert tf in (16, 8, 4, 2, 1) and smem <= 232448
    assert fused_logmel_ops.kernel_launch_config(4096, 160, 128)[0] == 4
    for hop in (110, 162, 1, 3):
        assert fused_logmel_ops.kernel_launch_config(512, hop, 128)[0] == 16
        assert fused_logmel_ops.kernel_launch_config(400, hop, 128)[0] == 16
    # the old shared-memory case: each frame staged on its own
    assert fused_logmel_ops.kernel_launch_config(512, 4096, 128)[1] <= 232448
    x = np.arange(1, 20001, dtype=np.float32)
    for n_fft, hop in ((512, 160), (512, 110), (512, 162), (512, 161), (512, 4096), (128, 128)):
        tf = fused_logmel_ops.kernel_launch_config(n_fft, hop, 40)[0]
        for t0 in (0, tf, 3 * tf):
            padded = np.pad(x, (0, (t0 + tf) * hop + n_fft))  # zeros past the row
            want = np.stack([padded[(t0 + f) * hop:(t0 + f) * hop + n_fft] for f in range(tf)])
            np.testing.assert_array_equal(_staged_frames(x, n_fft, hop, tf, t0), want)
    with pytest.raises(ValueError):
        fused_logmel_ops.kernel_launch_config(512, 160, 258)  # n_mels > n_freq
    with pytest.raises(ValueError, match="8192"):
        fused_logmel_ops.kernel_launch_config(8193, 160, 40)
    with pytest.raises(ValueError):
        fused_logmel_ops.kernel_launch_config(512, 0, 40)
    # the CPU takes any n_fft through the plain version
    x = torch.randn(1, 2000)
    win, fb = torch.ones(400), torch.tensor(mel.mel_filterbank(16000, 400, 40, 0.0, 8000.0))
    before = dict(_build.LAUNCHES)
    torch.testing.assert_close(fused_logmel(x, win, fb, n_fft=400, hop_length=160, num_frames=5),
                               logmel_plain(x, win, fb, n_fft=400, hop_length=160, num_frames=5))
    assert _build.LAUNCHES == before


def _kernel_dft_power(frames, n_fft):
    """csrc/fused_logmel.cu's direct DFT in float64 numpy over the wrapper's
    table: every bin k at once, n in order, the table index a = kn mod N
    kept by an add and a compare, one FMA pair a term; the power of bins
    0..n_fft/2."""
    tab = fused_logmel_ops.dft_table(n_fft, torch.device("cpu")).numpy()
    k = np.arange(n_fft // 2 + 1)
    a = np.zeros_like(k)
    re = np.zeros((frames.shape[0], k.size))
    im = np.zeros_like(re)
    for n in range(n_fft):
        w = tab[a]
        a = a + k
        a -= np.where(a >= n_fft, n_fft, 0)
        re += frames[:, n:n + 1] * w[None, :, 0]
        im += frames[:, n:n + 1] * w[None, :, 1]
    return re * re + im * im


@pytest.mark.parametrize("n_fft", [400, 321, 4096])
def test_kernel_dft_over_its_table_is_the_rfft(rng, n_fft):
    """The direct DFT's arithmetic over ``dft_table`` is the float64 rfft
    (torch.fft.rfft), odd n_fft included."""
    frames = rng.standard_normal((3, n_fft))
    tab = fused_logmel_ops.dft_table(n_fft, torch.device("cpu"))
    assert tab.dtype == torch.float64 and tab.shape == (n_fft, 2)
    ref = torch.fft.rfft(torch.tensor(frames), dim=1).abs().square().numpy()
    np.testing.assert_allclose(_kernel_dft_power(frames, n_fft), ref, rtol=0,
                               atol=1e-11 * ref.max())


def test_constant_tables_are_built_once():
    cpu = torch.device("cpu")
    assert fused_logmel_ops.fft_tables(512, cpu) is fused_logmel_ops.fft_tables(512, cpu)
    assert fused_logmel_ops.fft_tables(1024, cpu) is not fused_logmel_ops.fft_tables(512, cpu)
    spiral = (16000, 320, 512, 128, 0.0, 8000.0, cpu)
    win, fb = features.featurizer_constants(*spiral)
    again = features.featurizer_constants(*spiral)
    assert again[0] is win and again[1] is fb
    other = features.featurizer_constants(16000, 320, 512, 80, 0.0, 8000.0, cpu)
    assert other[1] is not fb and other[1].shape == (80, 257)
    np.testing.assert_array_equal(win.numpy(), _spiral_window())
    np.testing.assert_array_equal(fb.numpy(), mel.mel_filterbank(16000, 512, 128, 0.0, 8000.0))
    bands = fused_logmel_ops.mel_bands(fb)
    assert fused_logmel_ops.mel_bands(fb) is bands
    assert fused_logmel_ops.mel_bands(other[1]) is not bands
    edited = fb.clone()
    fused_logmel_ops.mel_bands(edited)
    edited[5] = 0.0  # an in-place edit is seen
    assert fused_logmel_ops.mel_bands(edited)[:, 5].tolist() == [0, 0]
    # the serving path runs under inference mode: what it caches there are
    # ordinary tensors, and an inference tensor (no version counter) still works
    with torch.inference_mode():
        inf_win, inf_fb = features.featurizer_constants(16000, 400, 512, 40, 0.0, 8000.0, cpu)
        inf_tab = fused_logmel_ops.fft_tables(256, cpu)
        torch.testing.assert_close(fused_logmel_ops.mel_bands(fb.clone()), bands)
    assert not (inf_win.is_inference() or inf_fb.is_inference() or inf_tab.is_inference())
    assert fused_logmel_ops.mel_bands(inf_fb) is fused_logmel_ops.mel_bands(inf_fb)


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


# n_fft 400 (not a power of two) at hop 160, and at 22 050 Hz with a 5 ms
# stride: hop 110, not a multiple of 4; 80 filters leave no filter empty
N_FFT_400 = {"hop160": dict(sample_rate=16000, window_size=0.02, window_stride=0.01),
             "hop110": dict(sample_rate=22050, window_size=0.015, window_stride=0.005)}


@pytest.mark.parametrize("conv", sorted(N_FFT_400))
def test_filterbank_features_n_fft_400_matches_jax_rfft_path(rng, conv, monkeypatch):
    """At n_fft 400 the two fp32 rfft pipelines (torch's and JAX's) each land
    about 1e-4 from the float64 features, on opposite sides in the first
    frame, so they are held to each other within 2e-4, and the port to the
    same pipeline in float64 within 1e-4 (at n_fft 512 they agree within
    2e-5 and test_filterbank_features_matches_jax_rfft_path holds 1e-4)."""
    kw = dict(N_FFT_400[conv], n_fft=400, nfilt=80)
    x, lens = _wavs(rng)
    ref, ref_lens = jax_features.filterbank_features(
        jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=False, **kw)
    out, out_lens = features.filterbank_features(torch.tensor(x), torch.tensor(lens), **kw)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    constants = features.featurizer_constants
    monkeypatch.setattr(features, "featurizer_constants",
                        lambda *a: tuple(t.double() for t in constants(*a)))
    out64, _ = features.filterbank_features(torch.tensor(x).double(), torch.tensor(lens), **kw)
    np.testing.assert_allclose(out.numpy(), out64.numpy(), atol=1e-4)


@pytest.mark.parametrize("conv", sorted(N_FFT_400))
def test_filterbank_features_n_fft_400_matches_jax_pallas_interpret(rng, conv):
    """The JAX featurizer's Pallas kernel (interpret mode) takes n_fft 400 and
    these hops too: the port's output is the same within its bound."""
    kw = dict(N_FFT_400[conv], n_fft=400, nfilt=80)
    x, lens = _wavs(rng, b=2, n=12000)
    ref, _ = jax_features.filterbank_features(
        jnp.asarray(x), jnp.asarray(lens), use_fused_kernel=True, **kw)
    out, _ = features.filterbank_features(torch.tensor(x), torch.tensor(lens), **kw)
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
    """The normalizations and magnitude powers that raised before they were
    ported now run (tests/test_torch_subword_slice.py holds them to JAX);
    training with dither and no generator still raises."""
    x = torch.randn(1, 4000, generator=torch.Generator().manual_seed(0)) * 0.1
    lens = torch.tensor([4000])
    for kw in (dict(normalize="per_feature_causal"), dict(mag_power=1.5),
               dict(normalize="all_features", mag_power=1.0)):
        out, out_lens = features.filterbank_features(x, lens, **kw)
        assert out.shape == (1, 32, 128) and bool(torch.isfinite(out).all()), kw
        assert out_lens.tolist() == [25]
    with pytest.raises(ValueError):
        features.filterbank_features(x, lens, training=True)  # dither, no generator
