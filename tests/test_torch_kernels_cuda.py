"""PyTorch port, the hand-written Hopper kernels against their plain versions.

Marked ``cuda``: each test needs a CUDA card and nvcc and skips without them
(the card is checked inside the fixture, never at import). This file imports
no JAX; on a CUDA machine without JAX run it past tests/conftest.py (which
imports JAX):  ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.
Inputs are fp32 with TF32 off, and bf16 for the kernels' bf16 variants.
"""

import numpy as np
import pytest
import torch

from tpu_speech_torch.audio.mel import hann_window, mel_filterbank
from tpu_speech_torch.models.spiral.features import hann_window_symmetric
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops import fused_attention as fa
from tpu_speech_torch.ops import fused_posconv as fp
from tpu_speech_torch.ops.fused_attention import (
    KERNEL_D_HEADS,
    KERNEL_D_HEADS_BF16,
    attention_plain,
    dropout_keep_mask,
    fused_qkv_self_attention,
    fused_self_attention,
    qkv_attention_plain,
)
from tpu_speech_torch.ops.fused_logmel import fused_logmel, logmel_plain
from tpu_speech_torch.ops.fused_posconv import grouped_conv1d, grouped_conv1d_plain
from tpu_speech_torch.ops.monotonic_align import maximum_path, maximum_path_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return torch.device("cuda")


def _counts(**launched):
    """Every launch counter at 0 but those given."""
    return dict(dict.fromkeys(_build.LAUNCHES, 0), **launched)


def _spiral_consts(dev):
    win = np.zeros(512, np.float32)
    win[96:416] = hann_window_symmetric(320)
    fb = mel_filterbank(16000, 512, 128, 0.0, 8000.0)
    return torch.tensor(win, device=dev), torch.tensor(fb, device=dev)


@pytest.mark.parametrize("frames", [1, 15, 16, 17, 100, 2401])
def test_fused_logmel_matches_plain(cuda, frames):
    win, fb = _spiral_consts(cuda)
    g = torch.Generator().manual_seed(frames)
    n = (frames - 1) * 160 + 512
    x = (torch.randn(3, n, generator=g) * 0.1).to(cuda)
    kw = dict(n_fft=512, hop_length=160, num_frames=frames)
    out = fused_logmel(x, win, fb, **kw)
    ref = logmel_plain(x, win, fb, **kw)
    torch.cuda.synchronize()
    # white noise: no near-zero-power bins; the bound tests/test_fused_logmel.py uses
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)


def test_fused_logmel_hifigan_convention(cuda):
    """mag_eps + clip modes (the HiFi-GAN mel), n_fft 1024, hop 256."""
    win = torch.tensor(hann_window(1024), device=cuda)
    fb = torch.tensor(mel_filterbank(22050, 1024, 80, 0.0, 8000.0), device=cuda)
    x = (torch.randn(2, 40000, generator=torch.Generator().manual_seed(0)) * 0.1).to(cuda)
    kw = dict(n_fft=1024, hop_length=256, num_frames=1 + (40000 - 1024) // 256,
              mag_mode="mag_eps", log_mode="clip", log_guard=1e-5)
    torch.testing.assert_close(fused_logmel(x, win, fb, **kw),
                               logmel_plain(x, win, fb, **kw), rtol=0, atol=2e-4)


# mels per n_fft: at 128 the slaney filters are narrower than a bin, so some
# rows are all zero (empty bands)
K1_MELS = {128: 40, 256: 80, 512: 128, 1024: 80, 2048: 128}


@pytest.mark.parametrize("n_fft", sorted(K1_MELS))
@pytest.mark.parametrize("hop", [128, 160, 256])
def test_fused_logmel_sizes_modes_and_tile_edges(cuda, n_fft, hop):
    """Every transform size and hop, both magnitude and both log modes, at
    frame counts around the kernel's tile of TF frames (1, TF - 1, TF, TF + 1
    and a ragged count), against the plain version on white noise."""
    from tpu_speech_torch.ops.fused_logmel import kernel_launch_config

    win = torch.tensor(hann_window(n_fft), device=cuda)
    fb = torch.tensor(mel_filterbank(16000, n_fft, K1_MELS[n_fft], 0.0, 8000.0), device=cuda)
    tf, _ = kernel_launch_config(n_fft, hop, K1_MELS[n_fft])
    g = torch.Generator().manual_seed(n_fft + hop)
    for frames in (1, tf - 1, tf, tf + 1, 3 * tf + 5):
        x = (torch.randn(2, (frames - 1) * hop + n_fft - 7, generator=g) * 0.1).to(cuda)
        for mag_mode in ("power", "mag_eps"):
            for log_mode in ("guard", "clip"):
                kw = dict(n_fft=n_fft, hop_length=hop, num_frames=frames, mag_mode=mag_mode,
                          log_mode=log_mode, log_guard=1e-5 if log_mode == "clip" else 2 ** -24)
                out = fused_logmel(x, win, fb, **kw)
                torch.cuda.synchronize()
                assert torch.isfinite(out).all()
                torch.testing.assert_close(out, logmel_plain(x, win, fb, **kw), rtol=0,
                                           atol=2e-4, msg=lambda m: f"{kw}: {m}")


def tones_over_noise(n, sr=16000, seed=1):
    """Two strong tones (440 Hz and 1234.5 Hz) over a noise floor 74 dB
    below them: near-zero-power bins everywhere off the tones."""
    t = np.arange(n) / sr
    noise = np.random.default_rng(seed).standard_normal(n)
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * 1234.5 * t)
            + 1e-4 * noise).astype(np.float32)


def test_fused_logmel_tones_against_float64(cuda):
    """On tones over a weak noise floor the log amplifies every rounding: the
    kernel is held against the float64 plain version, no worse than the fp32
    plain version's own error there plus 1e-4."""
    from tpu_speech_torch.models.spiral.features import stft_input

    win, fb = _spiral_consts(cuda)
    x = stft_input(torch.tensor(np.stack([tones_over_noise(8 * 16000, seed=s)
                                          for s in (1, 2)]), device=cuda), 512)
    kw = dict(n_fft=512, hop_length=160, num_frames=1 + (x.shape[1] - 512) // 160)
    out = fused_logmel(x, win, fb, **kw)
    p32 = logmel_plain(x, win, fb, **kw)
    p64 = logmel_plain(x.double(), win.double(), fb.double(), **kw)
    err = (out.double() - p64).abs().max().item()
    plain_err = (p32.double() - p64).abs().max().item()
    assert err <= plain_err + 1e-4, (err, plain_err)


# K1 past the FFT's sizes and hops: the direct DFT (n_fft 400, 321, 4096,
# 64) and the FFT's frame-by-frame staging (odd hop, hop >= n_fft)
K1_OTHER = [(400, 160), (400, 110), (321, 110), (321, 160), (4096, 160), (64, 32), (512, 161),
            (512, 1024), (128, 3)]


@pytest.mark.parametrize("n_fft,hop", K1_OTHER)
def test_fused_logmel_other_sizes_match_plain(cuda, n_fft, hop):
    """One launch of the kernel (never the plain version), both modes, frame
    counts around the tile, against the plain version on white noise (2e-4)
    and, on speech-like tones, against float64 within the plain version's
    own distance from it plus 1e-4."""
    from tpu_speech_torch.models.spiral.features import featurizer_constants, stft_input
    from tpu_speech_torch.ops.fused_logmel import kernel_launch_config

    n_mels = min(80, n_fft // 2 + 1)
    win, fb = featurizer_constants(16000, min(320, n_fft), n_fft, n_mels, 0.0, 8000.0, cuda)
    tf, _ = kernel_launch_config(n_fft, hop, n_mels)
    g = torch.Generator().manual_seed(n_fft + hop)
    for frames in (1, tf + 1, 3 * tf + 5):
        x = (torch.randn(2, (frames - 1) * hop + n_fft - 7, generator=g) * 0.1).to(cuda)
        for mag_mode, log_mode in (("power", "guard"), ("mag_eps", "clip")):
            kw = dict(n_fft=n_fft, hop_length=hop, num_frames=frames, mag_mode=mag_mode,
                      log_mode=log_mode, log_guard=1e-5 if log_mode == "clip" else 2 ** -24)
            _build.reset_launches()
            out = fused_logmel(x, win, fb, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES == _counts(fused_logmel=1)
            torch.testing.assert_close(out, logmel_plain(x, win, fb, **kw), rtol=0, atol=2e-4,
                                       msg=lambda m: f"{kw}: {m}")
    x = stft_input(torch.tensor(np.stack([tones_over_noise(2 * 16000, seed=s) for s in (1, 2)]),
                                device=cuda), n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop, num_frames=1 + (x.shape[1] - n_fft) // hop)
    out = fused_logmel(x, win, fb, **kw).double()
    p64 = logmel_plain(x.double(), win.double(), fb.double(), **kw)
    plain_err = (logmel_plain(x, win, fb, **kw).double() - p64).abs().max().item()
    assert (out - p64).abs().max().item() <= plain_err + 1e-4


@pytest.mark.parametrize("win,n_mels", [(320, 64), (400, 80)], ids=["quartznet", "conformer"])
def test_fused_logmel_conv_ctc_featurizer_shapes_match_plain(cuda, win, n_mels):
    """The conv-CTC featurizers' K1 (``ctc_models.py``: a 320-sample window
    in n_fft 512, 64 mels; ``conformer.py``: 400 in 512, 80 mels; hop 160):
    one launch, against float64 at 2e-4 and the plain version within its own
    distance from float64 plus 2e-4, on tones over a weak noise floor, at 1,
    16 and 2401 frames."""
    from tpu_speech_torch.models.spiral.features import featurizer_constants, stft_input

    w, fb = featurizer_constants(16000, win, 512, n_mels, 0.0, 8000.0, cuda)
    for seconds in (0.02, 0.17, 24.0):
        wav = np.stack([tones_over_noise(int(seconds * 16000), seed=s) for s in (1, 2)])
        x = stft_input(torch.tensor(wav, device=cuda), 512)
        kw = dict(n_fft=512, hop_length=160, num_frames=1 + (x.shape[1] - 512) // 160)
        _build.reset_launches()
        out = fused_logmel(x, w, fb, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == _counts(fused_logmel=1) and out.shape[-1] == n_mels
        p64 = logmel_plain(x.double(), w.double(), fb.double(), **kw)
        plain_err = (logmel_plain(x, w, fb, **kw).double() - p64).abs().max().item()
        assert (out.double() - p64).abs().max().item() <= min(2e-4, plain_err + 1e-4)
        torch.testing.assert_close(out, logmel_plain(x, w, fb, **kw), rtol=0,
                                   atol=plain_err + 2e-4)


@pytest.mark.parametrize("n_fft,hop", [(512, 160), (400, 160), (1024, 256)])
@pytest.mark.parametrize("power", [0.5, 1.5, 3.0])
def test_fused_logmel_pow_matches_plain(cuda, n_fft, hop, power):
    """mag_mode "pow" (|X|^p, the featurizer's mag_power other than 1 or 2):
    the kernel's float64 power^(p/2) against the plain version run in
    float64 at K1's 2e-4, and in fp32 (sqrt(power)^p after an fp32 rfft,
    whose rounding in the low-power bins p < 2 weighs more) at 5e-4."""
    win = torch.hann_window(n_fft, periodic=False).to(cuda)
    fb = torch.tensor(mel_filterbank(16000, n_fft, 80, 0.0, 8000.0), device=cuda)
    frames = 203
    g = torch.Generator().manual_seed(n_fft + int(power * 10))
    x = (torch.randn(3, (frames - 1) * hop + n_fft, generator=g) * 0.1).to(cuda)
    kw = dict(n_fft=n_fft, hop_length=hop, num_frames=frames, mag_mode="pow",
              mag_power=power)
    before = _build.LAUNCHES["fused_logmel"]
    out = fused_logmel(x, win, fb, **kw)
    ref = logmel_plain(x, win, fb, **kw)
    ref64 = logmel_plain(x.double(), win.double(), fb.double(), **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_logmel"] == before + 1
    torch.testing.assert_close(out.double(), ref64, rtol=0, atol=2e-4)
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-4)


def test_fused_logmel_steady_state_makes_no_copy_or_sync(cuda):
    """After the first call builds the tables, the featurizer on the card (and
    K1 in it) copies nothing from the host and never synchronises."""
    from tpu_speech_torch.models.spiral.features import filterbank_features

    x = (torch.randn(2, 16000, generator=torch.Generator().manual_seed(3)) * 0.1).to(cuda)
    lens = torch.tensor([16000, 9000], device=cuda)
    with torch.inference_mode():  # as the serving path runs it
        first, _ = filterbank_features(x, lens)
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, _ = filterbank_features(x, lens)
        with torch.inference_mode():
            served, _ = filterbank_features(x, lens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.LAUNCHES["fused_logmel"] == 2
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    torch.testing.assert_close(served, first, rtol=0, atol=0)


@pytest.mark.parametrize("d_head", KERNEL_D_HEADS)
@pytest.mark.parametrize("t", [5, 64, 131])
def test_fused_qkv_attention_matches_plain(cuda, d_head, t):
    b, h = 3, 4
    e = h * d_head
    g = torch.Generator().manual_seed(t * d_head)
    qkv = torch.randn(b, t, 3 * e, generator=g)
    qkv[..., :e] *= d_head ** -0.5
    qkv = qkv.to(cuda)
    lens = torch.tensor([0, t, max(1, t // 3)], device=cuda)  # row 0 fully padded
    mask = torch.arange(t, device=cuda)[None, :] >= lens[:, None]
    out = fused_qkv_self_attention(qkv, h, mask)
    ref = qkv_attention_plain(qkv, h, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(fused_qkv_self_attention(qkv, h),
                               qkv_attention_plain(qkv, h), rtol=0, atol=1e-4)


def _qkv_case(dev, b, t, h, d_head, seed):
    e = h * d_head
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3 * e, generator=g)
    qkv[..., :e] *= d_head ** -0.5
    lens = torch.tensor([0, t, max(1, t // 3)][:b], device=dev)  # row 0 fully padded
    mask = torch.arange(t, device=dev)[None, :] >= lens[:, None]
    return qkv.to(dev), mask


@pytest.mark.parametrize("d_head", KERNEL_D_HEADS)
@pytest.mark.parametrize("t", [5, 64, 131])
def test_fused_qkv_attention_dropout_matches_plain_replay(cuda, d_head, t):
    qkv, mask = _qkv_case(cuda, 3, t, 4, d_head, 7 * t + d_head)
    out = fused_qkv_self_attention(qkv, 4, mask, 0.1, 1234)
    ref = qkv_attention_plain(qkv, 4, mask, 0.1, 1234)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    assert not torch.allclose(out, fused_qkv_self_attention(qkv, 4, mask, 0.1, 1235))


@pytest.mark.parametrize("d_head", KERNEL_D_HEADS)
@pytest.mark.parametrize("t", [5, 64, 131])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_qkv_attention_backward_matches_plain_autograd(cuda, d_head, t, p):
    """dqkv of the K2-bwd kernel against autograd of the plain version on
    the same inputs and the same replayed mask; row 0 fully padded."""
    qkv, mask = _qkv_case(cuda, 3, t, 4, d_head, 11 * t + d_head)
    dout = torch.randn(3, t, 4 * d_head, generator=torch.Generator().manual_seed(t)).to(cuda)
    grads = []
    for fn in (fused_qkv_self_attention, qkv_attention_plain):
        x = qkv.clone().requires_grad_(True)
        fn(x, 4, mask, p, 99).backward(dout)
        grads.append(x.grad)
    torch.cuda.synchronize()
    got, ref = grads
    assert torch.isfinite(got).all()
    bound = 1e-4 * max(1.0, ref.abs().max().item())
    torch.testing.assert_close(got, ref, rtol=0, atol=bound)
    e = 4 * d_head
    assert got[0, :, :2 * e].abs().max().item() == 0.0  # dq, dk of the fully padded row


@pytest.mark.parametrize("dtype,d_head", [(torch.float32, 64), (torch.float32, 12),
                                           (torch.bfloat16, 64), (torch.bfloat16, 96)])
def test_k2_dropout_keyed_by_the_global_row(cuda, dtype, d_head):
    """A data-parallel rank's rows: the two halves of a batch at offsets
    b0 = 0 and B/2 give the whole batch's outputs and dqkv bit for bit, and
    each half matches the plain version at its offset within the K2 limits
    (float32: forward 1e-4, gradients 1e-4 x max(1, max|plain|); bf16: the
    bf16 limits); at another offset the masks differ."""
    b, t, h = 4, 131, 4
    qkv, mask = _qkv_case(cuda, 3, t, h, d_head, 41 * d_head)
    qkv = torch.cat([qkv, qkv[1:2]]).to(dtype)  # row 3 repeats row 1: its mask must not
    mask = torch.cat([mask, mask[1:2]])
    dout = torch.randn(b, t, h * d_head, generator=torch.Generator().manual_seed(5))
    dout = dout.to(cuda).to(dtype)

    def run(fn, rows, b0):
        x = qkv[rows].clone().requires_grad_(True)
        out = fn(x, h, mask[rows], 0.1, 77, b0)
        out.backward(dout[rows])
        return out.detach(), x.grad

    whole = run(fused_qkv_self_attention, slice(0, 4), 0)
    halves = [run(fused_qkv_self_attention, s, s.start) for s in (slice(0, 2), slice(2, 4))]
    torch.cuda.synchronize()
    for i in range(2):
        assert torch.equal(whole[i], torch.cat([hv[i] for hv in halves]))
    assert not torch.equal(whole[0][3], whole[0][1])
    for s, (out, grad) in zip((slice(0, 2), slice(2, 4)), halves):
        ref, ref_grad = run(qkv_attention_plain, s, s.start)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
            torch.testing.assert_close(grad, ref_grad, rtol=0,
                                       atol=1e-4 * max(1.0, ref_grad.abs().max().item()))
        else:
            for got, want, rtol in ((out, ref, BF16_FWD_RTOL), (grad, ref_grad, BF16_GRAD_RTOL)):
                torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                           atol=rtol * max(1.0, want.float().abs().max().item()))
    assert not torch.equal(run(fused_qkv_self_attention, slice(2, 4), 0)[0], halves[1][0])


# the kernels' tiles are 64 queries by 64 keys, 16 rows a warp, 8-wide
# tensor-core fragments: lengths around the tile edges and both path lengths
EDGE_T = [1, 63, 64, 65, 127, 129, 392, 604]


@pytest.mark.parametrize("d_head", KERNEL_D_HEADS)
@pytest.mark.parametrize("t", EDGE_T)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_tiling_edges_k2_and_k3(cuda, d_head, t, p):
    """K2 and K3, forward and backward, at the tiling's edges: padded rows, a
    fully padded row (its dq and dk exactly 0), dropout replayed; forward
    within 1e-4, gradients within 1e-4 x max(1, max|plain|)."""
    b, h = 3, 2
    qkv, mask = _qkv_case(cuda, b, t, h, d_head, 17 * t + d_head)
    dout = torch.randn(b, t, h * d_head, generator=torch.Generator().manual_seed(t)).to(cuda)
    q, k, v = (a.contiguous() for a in qkv.view(b, t, 3, h, d_head).unbind(2))
    cases = ((lambda *xs: fused_qkv_self_attention(*xs, h, mask, p, 5),
              lambda *xs: qkv_attention_plain(*xs, h, mask, p, 5), (qkv,), dout),
             (lambda *xs: fused_self_attention(*xs, mask, p, 5),
              lambda *xs: attention_plain(*xs, mask, p, 5), (q, k, v),
              dout.view(b, t, h, d_head)))
    for kernel, plain, inputs, g in cases:
        res = []
        for fn in (kernel, plain):
            xs = [a.clone().requires_grad_(True) for a in inputs]
            out = fn(*xs)
            out.backward(g)
            res.append((out.detach(), [x.grad for x in xs]))
        torch.cuda.synchronize()
        (out, grads), (ref, ref_grads) = res
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * max(1.0, want.abs().max().item()))
        padded_row = grads[0][0].reshape(t, -1)  # K3: dq; K2: dqkv
        if len(grads) == 1:
            padded_row = padded_row[:, :2 * h * d_head]  # K2: dq and dk
        assert padded_row.abs().max().item() == 0.0


def test_attention_raises_on_misaligned_operands(cuda):
    """The kernels stage rows with 16-byte copies: a q that starts 4 bytes
    into its storage is refused at launch, not computed some other way."""
    q = torch.randn(1 * 8 * 2 * 8 + 1, device=cuda)[1:].view(1, 8, 2, 8)
    k, v = torch.randn(2, 1, 8, 2, 8, device=cuda).unbind(0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_self_attention(q, k, v)


def test_dropout_keep_rate_and_streams(cuda):
    keep = dropout_keep_mask(5, 4, 8, 456, 0.1, cuda)
    n = keep.numel()
    rate = keep.float().mean().item()
    assert abs(rate - 0.9) < 4 * (0.9 * 0.1 / n) ** 0.5
    assert (keep[0, 0] != keep[0, 1]).any() and (keep[0, 0] != keep[1, 0]).any()
    assert (keep != dropout_keep_mask(6, 4, 8, 456, 0.1, cuda)).any()


def test_launch_counters_count_kernel_launches_only(cuda):
    win, fb = _spiral_consts(cuda)
    _build.reset_launches()
    x = torch.randn(1, 2000)
    fused_logmel(x, win.cpu(), fb.cpu(), n_fft=512, hop_length=160, num_frames=9)
    fused_qkv_self_attention(torch.randn(1, 4, 48), 2)
    q = torch.randn(1, 4, 2, 8)
    fused_self_attention(q, q, q)
    grouped_conv1d(torch.randn(1, 5, 8), torch.randn(8, 4, 3), 2, 1)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0)
    fused_logmel(x.to(cuda), win, fb, n_fft=512, hop_length=160, num_frames=9)
    fused_qkv_self_attention(torch.randn(1, 4, 48, device=cuda), 2)
    qkv = torch.randn(1, 4, 48, device=cuda, requires_grad=True)
    fused_qkv_self_attention(qkv, 2, None, 0.1, 3).sum().backward()
    q = torch.randn(1, 4, 2, 8, device=cuda, requires_grad=True)
    fused_self_attention(q, q.detach(), q.detach()).sum().backward()
    fused_self_attention(q.detach(), q.detach(), q.detach())
    xc = torch.randn(1, 5, 8, device=cuda, requires_grad=True)
    grouped_conv1d(xc, torch.randn(8, 4, 3, device=cuda), 2, 1).sum().backward()
    with torch.no_grad():
        grouped_conv1d(xc, torch.randn(8, 4, 3, device=cuda), 2, 1)
    assert _build.LAUNCHES == _counts(fused_logmel=1, fused_qkv_attention=2,
                                      fused_qkv_attention_bwd=1, fused_attention=2,
                                      fused_attention_bwd=1, grouped_conv1d=2,
                                      grouped_conv1d_dx=1)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    qkv = torch.randn(1, 4, 48, device=cuda)
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv, 2, dropout_p=0.1)  # no seed
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv.double(), 2)
    with pytest.raises(ValueError):
        fused_qkv_self_attention(torch.randn(1, 4, 3 * 40, device=cuda), 1)  # d_head 40
    win, fb = _spiral_consts(cuda)
    with pytest.raises(ValueError):
        fused_logmel(torch.randn(1, 2000, device=cuda).double(), win, fb,
                     n_fft=512, hop_length=160, num_frames=9)
    with pytest.raises(ValueError):  # past the direct DFT's 8192
        fused_logmel(torch.randn(1, 20000, device=cuda), torch.ones(8200, device=cuda),
                     torch.ones(40, 4101, device=cuda), n_fft=8200, hop_length=162,
                     num_frames=9)
    q = torch.randn(1, 4, 2, 8, device=cuda)
    with pytest.raises(ValueError):
        fused_self_attention(q, q, q, dropout_p=0.1)  # no seed
    with pytest.raises(ValueError):
        fused_self_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        q40 = torch.randn(1, 4, 2, 40, device=cuda)
        fused_self_attention(q40, q40, q40)  # d_head 40
    x = torch.randn(1, 9, 130, device=cuda)
    with pytest.raises(ValueError):
        grouped_conv1d(x, torch.randn(130, 65, 8, device=cuda), 2, 4)  # Cg 65
    with pytest.raises(ValueError):
        grouped_conv1d(x[..., :128], torch.randn(128, 8, 129, device=cuda), 16, 64)  # K 129
    with pytest.raises(ValueError):
        grouped_conv1d(x[..., :128].double(), torch.randn(128, 8, 8, device=cuda).double(), 16, 4)
    with pytest.raises(ValueError):
        grouped_conv1d(x[..., :128], torch.randn(128, 8, 8), 16, 4)  # weights on the CPU


def test_tiny_slice_on_the_card_matches_the_cpu(cuda):
    from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char
    from tpu_speech_torch.models.spiral.st2vec import wav_to_spec
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = spiral_tiny_ctc_char()
    model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    wavs = torch.randn(2, 16000, generator=g) * 0.1
    lens = torch.tensor([16000, 7000])
    wavs[1, 7000:] = 0
    with torch.no_grad():
        ref, ref_lens = model(*wav_to_spec(cfg.model.encoder, wavs, lens))
        model.to(cuda)
        _build.reset_launches()
        out, out_lens = model(*wav_to_spec(cfg.model.encoder, wavs.to(cuda), lens.to(cuda)))
    assert _build.LAUNCHES == _counts(fused_logmel=1, fused_qkv_attention=2,
                                      grouped_conv1d=2)
    torch.testing.assert_close(out_lens.cpu(), ref_lens)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-3)


def test_tiny_pretrain_step_on_the_card_matches_the_cpu(cuda):
    """One pretrain step of the tiny config on both devices from the same
    weights, batch and negatives (dither, dropout and layerdrop off, SGD
    lr = 1): the loss, every gradient, and the launch counts of one step."""
    import dataclasses

    from tpu_speech_torch.configs.spiral import spiral_tiny_pretrain
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, draw_negative_indices
    from tpu_speech_torch.train import spiral as tspiral

    enc = spiral_tiny_pretrain().model.encoder
    enc = dataclasses.replace(enc, dither=0.0, blocks=tuple(
        dataclasses.replace(b, transformer=dataclasses.replace(b.transformer, attention_dropout=0.0))
        for b in enc.blocks))
    r = np.random.default_rng(0)
    wavs = (r.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lens = np.array([16000, 9000], np.int32)
    batch = tspiral.host_augment_batch(enc, wavs, lens, wavs, lens, 112,
                                       np.random.default_rng(1))
    neg = draw_negative_indices(torch.tensor([13, 8]), 14, enc.n_negatives,
                                torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", cuda):
        model = ST2VecEncoder(enc, pretraining=True).init_weights(torch.Generator().manual_seed(0))
        state = tspiral.make_pretrain_state(model.to(dev), lambda ps: torch.optim.SGD(ps, lr=1.0))
        _build.reset_launches()
        m = tspiral.pretrain_step(state, tspiral.batch_to_device(batch, dev),
                                  DropoutRng.seeded(0, dev), neg_idx=neg.to(dev))
        out[str(dev)] = (float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()
                                            if p.requires_grad}, dict(_build.LAUNCHES))
    (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert n_cpu == dict.fromkeys(_build.LAUNCHES, 0)
    assert n_gpu == _counts(fused_logmel=2, fused_qkv_attention=4, fused_qkv_attention_bwd=2,
                            grouped_conv1d=4, grouped_conv1d_dx=2)
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    for k in g_cpu:
        bound = 1e-3 * max(g_cpu[k].abs().max().item(), 1e-2 * g_max)
        torch.testing.assert_close(g_gpu[k], g_cpu[k], rtol=0, atol=bound, msg=k)


# SPIRAL-large's two transformer blocks at 42 s (B = 18): (B, T, H, d_head)
LARGE_ATTENTION = [(18, 1050, 8, 64), (18, 525, 16, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,h,d_head", LARGE_ATTENTION)
def test_k2_at_the_large_shapes_matches_plain(cuda, dtype, b, t, h, d_head):
    """K2-fwd and K2-bwd at SPIRAL-large's shapes, with padded keys and
    dropout 0.1, against the plain version and its autograd: fp32 at 1e-4 x
    max(1, max|plain|), bf16 at the bf16 limits (8e-3, 1.6e-2)."""
    e = h * d_head
    gen = torch.Generator().manual_seed(t + h)
    qkv = torch.randn(b, t, 3 * e, generator=gen)
    qkv[..., :e] *= d_head ** -0.5
    qkv = qkv.to(cuda).to(dtype)
    lens = torch.linspace(t // 2, t, b).long().to(cuda)
    mask = torch.arange(t, device=cuda)[None, :] >= lens[:, None]
    dout = torch.randn(b, t, e, generator=gen).to(cuda).to(dtype)
    res = []
    for fn in (fused_qkv_self_attention, qkv_attention_plain):
        x = qkv.clone().requires_grad_(True)
        out = fn(x, h, mask, 0.1, 17)
        out.backward(dout)
        res.append((out.detach().float(), x.grad.float()))
    torch.cuda.synchronize()
    (out, grad), (ref, ref_grad) = res
    fwd, bwd = (1e-4, 1e-4) if dtype == torch.float32 else (8e-3, 1.6e-2)
    torch.testing.assert_close(out, ref, rtol=0, atol=fwd * max(1.0, ref.abs().max().item()))
    torch.testing.assert_close(grad, ref_grad, rtol=0,
                               atol=bwd * max(1.0, ref_grad.abs().max().item()))


# ---- K4: the grouped positional conv ----------------------------------------

# (B, T, C, groups, K): the tiny and toy configs' Cg 8 and 12, odd K, ragged
# tiles; SPIRAL-base's two blocks (Cg 32 and 48, K 128); large's Cg 64, and
# SPIRAL-large's two blocks at 42 s (B = 18)
K4_SHAPES = [(2, 37, 32, 4, 8), (3, 50, 48, 4, 7), (2, 129, 192, 16, 16),
             (14, 604, 512, 16, 128), (14, 302, 768, 16, 128), (2, 300, 1024, 16, 128),
             (18, 1050, 512, 16, 128), (18, 525, 1024, 16, 128)]


def _conv_case(dev, b, t, c, g, k, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=gen)
    w = torch.randn(c, c // g, k, generator=gen) * (c // g * k) ** -0.5
    return x.to(dev), w.to(dev)


@pytest.mark.parametrize("b,t,c,g,k", K4_SHAPES)
def test_grouped_conv1d_matches_plain(cuda, b, t, c, g, k):
    """Forward at the SAME-even (K//2), dx's (K//2 - 1) and causal (K-1)
    left pads. Both sum C/groups * K fp32 products in different orders:
    1e-4 x max(1, max|plain|)."""
    x, w = _conv_case(cuda, b, t, c, g, k, b * t + k)
    for left in sorted({k // 2, max(k // 2 - 1, 0), k - 1}):
        out = grouped_conv1d(x, w, g, left)
        ref = grouped_conv1d_plain(x, w, g, left)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-4 * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("b,t,c,g,k", K4_SHAPES)
def test_grouped_conv1d_backward_matches_plain_autograd(cuda, b, t, c, g, k):
    """dx (K4 on the flipped, swapped weights) and dw (the library's weight
    gradient) against autograd of the plain version."""
    x, w = _conv_case(cuda, b, t, c, g, k, 3 * t + k)
    dy = torch.randn(b, t, c, generator=torch.Generator().manual_seed(t)).to(cuda)
    grads = []
    for fn in (grouped_conv1d, grouped_conv1d_plain):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        fn(xx, ww, g, k // 2).backward(dy)
        grads.append((xx.grad, ww.grad))
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * max(1.0, ref.abs().max().item()))


# ---- K3: attention on (B, T, H, D) q, k, v -----------------------------------

@pytest.mark.parametrize("d_head", KERNEL_D_HEADS)
@pytest.mark.parametrize("t", [5, 64, 131])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_self_attention_matches_plain(cuda, d_head, t, p):
    """K3 forward and dq, dk, dv against the plain version and its autograd
    on the same replayed mask; row 0 fully padded."""
    b, h = 3, 4
    gen = torch.Generator().manual_seed(13 * t + d_head)
    q, k, v = (torch.randn(b, t, h, d_head, generator=gen).to(cuda) for _ in range(3))
    q = q * d_head ** -0.5
    lens = torch.tensor([0, t, max(1, t // 3)], device=cuda)
    mask = torch.arange(t, device=cuda)[None, :] >= lens[:, None]
    dout = torch.randn(b, t, h, d_head, generator=gen).to(cuda)
    res = []
    for fn in (fused_self_attention, attention_plain):
        xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
        out = fn(*xs, mask, p, 99)
        out.backward(dout)
        res.append([out.detach()] + [x.grad for x in xs])
    torch.cuda.synchronize()
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=1e-4)
    for got, ref in zip(res[0][1:], res[1][1:]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * max(1.0, ref.abs().max().item()))
    assert res[0][1][0].abs().max().item() == 0.0  # dq of the fully padded row


def test_k3_and_k2_are_one_kernel_by_strides(cuda):
    """K3 on the (B, T, H, D) views of a merged plane's thirds equals K2 on
    the plane, forward and gradient, with dropout: bit for bit."""
    b, t, h, d = 2, 77, 4, 16
    qkv = torch.randn(b, t, 3 * h * d, generator=torch.Generator().manual_seed(1)).to(cuda)
    x = qkv.clone().requires_grad_(True)
    out2 = fused_qkv_self_attention(x, h, None, 0.1, 5)
    out2.sum().backward()
    xs = [qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d).clone().requires_grad_(True)
          for i in range(3)]
    out3 = fused_self_attention(*xs, None, 0.1, 5)
    out3.sum().backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(out3.reshape(b, t, h * d), out2, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([a.grad.reshape(b, t, h * d) for a in xs], -1),
                               x.grad, rtol=0, atol=0)


def test_tiny_finetune_step_on_the_card_matches_the_cpu(cuda):
    """One finetune step of the tiny CTC config on both devices from the same
    weights and batch (dither, dropout and layerdrop off, SGD lr = 1), frozen
    and unfrozen: the loss, every gradient, and the launch counts (K4-dx and
    K2-bwd only when the encoder is not frozen)."""
    import dataclasses

    from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
    from tpu_speech_torch.train.spiral import batch_to_device
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = spiral_tiny_ctc_char()
    enc = cfg.model.encoder
    cfg.model.encoder = dataclasses.replace(enc, dither=0.0, blocks=tuple(
        dataclasses.replace(b, transformer=dataclasses.replace(b.transformer, attention_dropout=0.0))
        for b in enc.blocks))
    dec = cfg.model.decoder
    cfg.model.decoder = dataclasses.replace(dec, upsample_dropout=0.0, conv_layers=tuple(
        dataclasses.replace(c, dropout=0.0) for c in dec.conv_layers))
    r = np.random.default_rng(0)
    wavs = (r.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lens = np.array([16000, 9000], np.int32)
    labels = np.zeros((2, 512), np.int32)
    labels[:, :7] = r.integers(0, 28, size=(2, 7))
    batch = {"wavs": wavs, "wav_lens": lens, "labels": labels,
             "label_lens": np.array([7, 4], np.int32)}
    for frozen in (True, False):
        out = {}
        for dev in ("cpu", cuda):
            model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(0))
            state = make_finetune_state(model.to(dev), lambda ps: torch.optim.SGD(ps, lr=1.0))
            _build.reset_launches()
            m = finetune_step(state, batch_to_device(batch, dev), DropoutRng.seeded(0, dev),
                              freeze_encoder=frozen)
            out[str(dev)] = (float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()},
                             dict(_build.LAUNCHES))
        (l_cpu, g_cpu, n_cpu), (l_gpu, g_gpu, n_gpu) = out["cpu"], out["cuda"]
        assert n_cpu == dict.fromkeys(_build.LAUNCHES, 0)
        assert n_gpu == _counts(fused_logmel=1, fused_qkv_attention=2,
                                fused_qkv_attention_bwd=0 if frozen else 2, grouped_conv1d=2,
                                grouped_conv1d_dx=0 if frozen else 2)
        assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
        g_max = max(g.abs().max().item() for g in g_cpu.values())
        for k in g_cpu:
            bound = 1e-3 * max(g_cpu[k].abs().max().item(), 1e-2 * g_max)
            torch.testing.assert_close(g_gpu[k], g_cpu[k], rtol=0, atol=bound, msg=k)
            if frozen and k.startswith("encoder."):
                assert not g_gpu[k].any()


# ---- the bf16 variants -------------------------------------------------------

# lengths around the 64-row tiles of the wgmma kernels (one, two and four
# key tiles and their edges) and the 16-wide k steps, and the pretrain and
# finetune block-1 lengths
BF16_EDGE_T = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 257, 392, 604]
# against the plain version, which rounds at the same points: x max(1,
# max|plain|), about one bf16 step at the largest value
BF16_FWD_RTOL, BF16_GRAD_RTOL = 8e-3, 1.6e-2
# and no more than this factor farther than the plain version from the
# float64 result on the same bf16 values (L2 over all elements), give or take
# half a bf16 step of that result's norm (where the plain version lands on
# it, as at T = 1, where dS is zero but for rounding)
BF16_F64_FACTOR = 1.25


def _f64_attention(q, k, v, mask, p, seed):
    """Attention in float64 on the bf16 values: no rounding in between."""
    b, t, h, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.double(), k.double())
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :], -1e9)
    pr = torch.softmax(s, -1)
    if p > 0.0:
        pr = pr * dropout_keep_mask(seed, b, h, t, p, q.device) / (1.0 - p)
    return torch.einsum("bhts,bshd->bthd", pr, v.double())


def _l2(xs, ref):
    return sum((x.double() - r).square().sum().item() for x, r in zip(xs, ref)) ** 0.5


def _norm(xs):
    return sum(x.double().square().sum().item() for x in xs) ** 0.5


def _hold_bf16(got, plain, f64, rtol, what):
    """bf16 ``got`` within rtol x max(1, max|plain|) of ``plain`` each, and
    all of them together no more than BF16_F64_FACTOR as far from ``f64``
    (+ 2**-9 of its norm)."""
    for a, r in zip(got, plain):
        assert a.dtype == r.dtype == torch.bfloat16 and torch.isfinite(a).all(), what
        torch.testing.assert_close(a.float(), r.float(), rtol=0,
                                   atol=rtol * max(1.0, r.float().abs().max().item()),
                                   msg=lambda m: f"{what}: {m}")
    e_got, e_plain = _l2(got, f64), _l2(plain, f64)
    assert e_got <= BF16_F64_FACTOR * e_plain + 2**-9 * _norm(f64), (what, e_got, e_plain)


@pytest.mark.parametrize("d_head", KERNEL_D_HEADS_BF16)
@pytest.mark.parametrize("t", BF16_EDGE_T)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_bf16_attention_k2_and_k3_match_plain(cuda, d_head, t, p):
    """K2 and K3 on bf16 operands, forward and backward, against the plain
    versions rounding at the kernels' points (P~ and dS to bf16, Delta from
    the bf16 output): padded rows, a fully padded row (its dq and dk exactly
    0), dropout replayed; each also against float64 on the same bf16
    values."""
    b, h = 3, 2
    e = h * d_head
    qkv32, mask = _qkv_case(cuda, b, t, h, d_head, 23 * t + d_head)
    qkv = qkv32.bfloat16()
    dout = torch.randn(b, t, e, generator=torch.Generator().manual_seed(t)).to(cuda).bfloat16()
    q, k, v = (a.contiguous() for a in qkv.view(b, t, 3, h, d_head).unbind(2))

    def f64_k2(x):
        return _f64_attention(*x.view(b, t, 3, h, d_head).unbind(2), mask, p, 5).reshape(b, t, e)

    cases = ((lambda *xs: fused_qkv_self_attention(*xs, h, mask, p, 5),
              lambda *xs: qkv_attention_plain(*xs, h, mask, p, 5), f64_k2, (qkv,), dout),
             (lambda *xs: fused_self_attention(*xs, mask, p, 5),
              lambda *xs: attention_plain(*xs, mask, p, 5),
              lambda *xs: _f64_attention(*xs, mask, p, 5), (q, k, v),
              dout.view(b, t, h, d_head)))
    for name, (kernel, plain, exact, inputs, g) in zip(("K2", "K3"), cases):
        res = []
        for fn, cast in ((kernel, None), (plain, None), (exact, torch.float64)):
            xs = [(a.to(cast) if cast else a.clone()).requires_grad_(True) for a in inputs]
            out = fn(*xs)
            out.backward(g.to(out.dtype))
            res.append((out.detach(), [x.grad for x in xs]))
        torch.cuda.synchronize()
        (out, grads), (ref, ref_grads), (out64, grads64) = res
        _hold_bf16([out], [ref], [out64], BF16_FWD_RTOL, f"{name} forward T={t}")
        _hold_bf16(grads, ref_grads, grads64, BF16_GRAD_RTOL, f"{name} backward T={t}")
        padded_row = grads[0][0].reshape(t, -1)  # K3: dq; K2: dqkv
        if name == "K2":
            padded_row = padded_row[:, :2 * e]
        assert padded_row.abs().max().item() == 0.0


@pytest.mark.parametrize("d_head", KERNEL_D_HEADS_BF16)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_bf16_attention_is_deterministic(cuda, d_head, p):
    """Two launches of the bf16 K2 and K3 kernels on the same inputs give the
    same bits: out and lse forward, dq, dk and dv backward (no atomics, every
    sum in a fixed order)."""
    b, t, h = 3, 200, 2
    qkv32, mask = _qkv_case(cuda, b, t, h, d_head, 31 * d_head)
    qkv = qkv32.bfloat16()
    dout = torch.randn(b, t, h * d_head, generator=torch.Generator().manual_seed(3))
    dout = dout.to(cuda).bfloat16()
    q, k, v = (a.contiguous() for a in qkv.view(b, t, 3, h, d_head).unbind(2))
    thresh, scale = fa.dropout_threshold(p) if p else 0, 1.0 / (1.0 - p)

    def k2():
        out, lse = fa._launch_fwd(qkv, mask, h, 9, thresh, scale, True)
        return out, lse, fa._launch_bwd(qkv, mask, out, dout, lse, h, 9, thresh, scale)

    def k3():
        out, lse = fa._launch_attn_fwd(q, k, v, mask, 9, thresh, scale, True)
        g = dout.view(b, t, h, d_head)
        return (out, lse, *fa._launch_attn_bwd(q, k, v, mask, out, g, lse, 9, thresh, scale))

    for run in (k2, k3):
        first, second = run(), run()
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y)


def test_bf16_attention_raises_on_misaligned_operands(cuda):
    """The bf16 kernels load tiles by TMA, which needs 16-byte aligned rows:
    a q that starts 2 bytes into its storage, and a row stride that is not a
    multiple of 16 bytes, are refused at launch, not computed another way."""
    q = torch.randn(1 * 8 * 2 * 16 + 1, device=cuda).bfloat16()[1:].view(1, 8, 2, 16)
    k, v = torch.randn(2, 1, 8, 2, 16, device=cuda).bfloat16().unbind(0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_self_attention(q, k, v)
    plane = torch.randn(1, 8, 3 * 32 + 4, device=cuda).bfloat16()  # rows of 100 elements
    ptrs = (plane.data_ptr(), plane.data_ptr() + 64, plane.data_ptr() + 128)
    err, _, _ = fa._fwd(ptrs, plane.shape[2], None, 1, 8, 2, 16, 0, 0, 1.0, False, cuda,
                        torch.bfloat16)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(err, "fused_qkv_self_attention")


# (B, T, C, groups, K): Cg 16, 32, 48, 64 around the kernel's 64-frame tiles
# and its blocks (256 frames, 128 at Cg 64), K not a multiple of the taps a
# chunk (7, 9), the six SPIRAL-base shapes of the paths (Cg 32 and 48, K
# 128: chip_smoke.py's K4_SHAPES) and SPIRAL-large's two (Cg 32 and 64)
BF16_K4_SHAPES = [(2, 1, 256, 16, 128), (2, 17, 64, 4, 7), (3, 127, 512, 16, 16),
                  (2, 128, 768, 16, 128), (2, 129, 1024, 16, 128), (1, 63, 256, 16, 8),
                  (2, 64, 512, 16, 16), (2, 65, 512, 16, 128), (1, 255, 768, 16, 16),
                  (1, 256, 512, 16, 128), (2, 257, 1024, 16, 128), (1, 513, 256, 16, 9),
                  (14, 604, 512, 16, 128), (14, 302, 768, 16, 128), (24, 392, 512, 16, 128),
                  (24, 456, 512, 16, 128), (24, 196, 768, 16, 128), (24, 228, 768, 16, 128),
                  (18, 1050, 512, 16, 128), (18, 525, 1024, 16, 128)]


@pytest.mark.parametrize("b,t,c,g,k", BF16_K4_SHAPES)
def test_bf16_grouped_conv1d_matches_plain(cuda, b, t, c, g, k):
    """K4 on bf16 x and w at the SAME, dx's and causal left pads, and dx (K4
    on the flipped weights) and dw (the library's bf16 weight gradient)
    against autograd of the plain version (float32 products of the bf16
    values, one rounding); forward and dx also against float64."""
    x32, w32 = _conv_case(cuda, b, t, c, g, k, 5 * t + k)
    x, w = x32.bfloat16(), w32.bfloat16()
    x64, w64 = x.double(), w.double()
    for left in sorted({k // 2, max(k // 2 - 1, 0), k - 1}):
        out = grouped_conv1d(x, w, g, left)
        ref = grouped_conv1d_plain(x, w, g, left)
        exact = grouped_conv1d_plain(x64, w64, g, left)
        torch.cuda.synchronize()
        _hold_bf16([out], [ref], [exact], BF16_FWD_RTOL, f"K4 left {left}")
    dy = torch.randn(b, t, c, generator=torch.Generator().manual_seed(t)).to(cuda).bfloat16()
    grads = []
    for fn, xx, ww in ((grouped_conv1d, x, w), (grouped_conv1d_plain, x, w),
                       (grouped_conv1d_plain, x64, w64)):
        xx, ww = xx.clone().requires_grad_(True), ww.clone().requires_grad_(True)
        fn(xx, ww, g, k // 2).backward(dy.to(xx.dtype))
        grads.append((xx.grad, ww.grad))
    torch.cuda.synchronize()
    (gx, gw), (rx, rw), (ex, _) = grads
    _hold_bf16([gx], [rx], [ex], BF16_GRAD_RTOL, "K4-dx")
    assert gw.dtype == torch.bfloat16
    torch.testing.assert_close(gw.float(), rw.float(), rtol=0,
                               atol=BF16_GRAD_RTOL * max(1.0, rw.float().abs().max().item()))


@pytest.mark.parametrize("c", [512, 768])
def test_bf16_grouped_conv1d_is_deterministic(cuda, c):
    """Two launches of the bf16 K4 kernel on the same inputs give the same
    bits, forward and dx (K4 on the flipped weights): every sum runs in a
    fixed order and no block adds into another's output."""
    x32, w32 = _conv_case(cuda, 3, 300, c, 16, 128, c)
    x, w = x32.bfloat16(), w32.bfloat16()
    dy = torch.randn(3, 300, c, generator=torch.Generator().manual_seed(c)).to(cuda).bfloat16()

    def run():
        xx = x.clone().requires_grad_(True)
        out = grouped_conv1d(xx, w, 16, 64)
        out.backward(dy)
        return out.detach(), xx.grad

    (out1, dx1), (out2, dx2) = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(dx1, dx2)


@pytest.mark.parametrize("cg", (16, 32, 48, 64))
@pytest.mark.parametrize("k", (1, 9, 128))
def test_bf16_weight_layout_kernel_matches_plain(cuda, cg, k):
    """The bf16 layout kernel gives the bits of ``weights_plain``, forward and
    dx (channels swapped, taps flipped), at every Cg the conv takes."""
    w = torch.randn(3 * cg, cg, k, generator=torch.Generator().manual_seed(cg + k)).bfloat16()
    for dx, launch in ((False, fp.kernel_weights), (True, fp._dx_weights)):
        got = launch(w.to(cuda), 3)
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == (3, k, cg // 8, cg, 8)
        assert torch.equal(got.cpu(), fp.weights_plain(w, 3, dx)), dx


def test_bf16_grouped_conv1d_raises_on_misaligned_operands(cuda):
    """The bf16 K4 kernel loads x and the weights by TMA, which needs
    16-byte aligned bases: an x that starts 2 bytes into its storage, and
    kernel-layout weights that do, are refused at launch, not computed
    another way."""
    x = torch.randn(2 * 9 * 512 + 1, device=cuda).bfloat16()[1:].view(2, 9, 512)
    w = torch.randn(512, 32, 8, device=cuda).bfloat16()
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        grouped_conv1d(x, w, 16, 4)
    wk = fp.kernel_weights(w, 16)
    wk_off = torch.empty(wk.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(wk.shape)
    wk_off.copy_(wk)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fp._launch(x.contiguous().clone(), wk_off, 4, "grouped_conv1d")


def test_bf16_wrappers_raise_instead_of_falling_back(cuda):
    """What the bf16 kernels do not take raises on the card: d_head 8, float16,
    Cg 8, mixed dtypes."""
    with pytest.raises(ValueError):
        fused_qkv_self_attention(torch.randn(1, 4, 48, device=cuda).bfloat16(), 2)  # d 8
    with pytest.raises(ValueError):
        fused_qkv_self_attention(torch.randn(1, 4, 192, device=cuda).half(), 2)
    q = torch.randn(1, 4, 2, 8, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        fused_self_attention(q, q, q)
    x = torch.randn(1, 9, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        grouped_conv1d(x, torch.randn(128, 8, 8, device=cuda).bfloat16(), 16, 4)  # Cg 8
    with pytest.raises(ValueError):
        grouped_conv1d(x, torch.randn(128, 32, 8, device=cuda), 4, 4)  # w float32


def test_bf16_launch_counters(cuda):
    """A bf16 launch counts under the kernel's ``_bf16`` name only."""
    _build.reset_launches()
    qkv = torch.randn(1, 4, 96, device=cuda).bfloat16().requires_grad_(True)
    fused_qkv_self_attention(qkv, 2, None, 0.1, 3).float().sum().backward()
    q = torch.randn(1, 4, 2, 16, device=cuda).bfloat16().requires_grad_(True)
    fused_self_attention(q, q.detach(), q.detach()).float().sum().backward()
    xc = torch.randn(1, 5, 64, device=cuda).bfloat16().requires_grad_(True)
    grouped_conv1d(xc, torch.randn(64, 16, 3, device=cuda).bfloat16(), 4, 1).float().sum().backward()
    assert _build.LAUNCHES == _counts(
        fused_qkv_attention_bf16=1, fused_qkv_attention_bwd_bf16=1, fused_attention_bf16=1,
        fused_attention_bwd_bf16=1, grouped_conv1d_bf16=1, grouped_conv1d_dx_bf16=1)


def test_bf16_pretrain_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 pretrain step at SPIRAL-base width with one layer per block
    (B = 2 x 1 s, dither, dropout and layerdrop off, SGD lr = 1) on the card
    and on the CPU (the plain versions, rounding at the same points), and
    the fp32 step on the CPU: only the bf16 kernels launch (and K1, which
    stays float32), the parameters and gradients stay float32, and the
    card's bf16 step is no farther from the fp32 step than the JAX parity
    tests allow against the CPU's bf16 step: the loss within 2 x the CPU
    bf16 loss's distance + 5e-3 relative, each gradient leaf (max|g| at
    least 1 % of the largest) within 2 x its distance + 1e-2 in L2 (the
    first layers' gradients are 0.1-0.2 apart in relative L2 in either
    bf16 step)."""
    import dataclasses

    from tpu_speech_torch.configs.spiral import spiral_base_pretrain_ls960
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, draw_negative_indices
    from tpu_speech_torch.train import spiral as tspiral

    enc = spiral_base_pretrain_ls960().model.encoder
    enc = dataclasses.replace(enc, dither=0.0, blocks=tuple(dataclasses.replace(
        b, transformer=dataclasses.replace(
            b.transformer, encoder_layers=1, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, encoder_layerdrop=0.0),
        conv_layers=tuple(dataclasses.replace(c, dropout=0.0) for c in b.conv_layers))
        for b in enc.blocks))
    r = np.random.default_rng(0)
    n = 16000
    wavs = (r.standard_normal((2, n)) * 0.1).astype(np.float32)
    lens = np.array([n, 12000], np.int32)
    spec_len = ((1 + n // 160 + 15) // 16) * 16
    batch = tspiral.host_augment_batch(enc, wavs, lens, wavs * 0.8, lens, spec_len,
                                       np.random.default_rng(1), np.random.default_rng(2))
    feat_lens = torch.tensor(np.ceil(lens / 160).astype(np.int64))
    for _ in range(3):
        feat_lens = (feat_lens + 1) // 2
    neg = draw_negative_indices(feat_lens, spec_len // 8, enc.n_negatives,
                                torch.Generator().manual_seed(3))
    out = {}
    for dev, bf16 in (("cpu", False), ("cpu", True), (cuda, True)):
        model = ST2VecEncoder(enc, pretraining=True).init_weights(torch.Generator().manual_seed(0))
        state = tspiral.make_pretrain_state(model.to(dev), lambda ps: torch.optim.SGD(ps, lr=1.0))
        _build.reset_launches()
        m = tspiral.pretrain_step(state, tspiral.batch_to_device(batch, dev),
                                  DropoutRng.seeded(0, dev), bf16=bf16, neg_idx=neg.to(dev))
        assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.student_parameters())
        out[(str(dev), bf16)] = (float(m["loss"]), dict(_build.LAUNCHES), {
            n: p.grad.cpu() for n, p in model.named_parameters() if p.requires_grad})
    (l32, _, g32), (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = out.values()
    assert n_cpu == _counts()
    assert n_gpu == _counts(fused_logmel=2, fused_qkv_attention_bf16=4,
                            fused_qkv_attention_bwd_bf16=2, grouped_conv1d_bf16=4,
                            grouped_conv1d_dx_bf16=2)
    assert abs(l_gpu - l32) <= 2 * abs(l_cpu - l32) + 5e-3 * abs(l32), (l_gpu, l_cpu, l32)
    g_max = max(g.abs().max().item() for g in g32.values())
    for k, g in g32.items():
        if g.abs().max().item() >= 1e-2 * g_max:
            assert (g_gpu[k] - g).norm() <= 2 * (g_cpu[k] - g).norm() + 1e-2 * g.norm(), k


TTS_TEXT = ("The quick brown fox jumps over the lazy dog while the curious cat watches from a "
            "sunlit windowsill in the early morning.")


def test_tts_full_width_card_matches_the_cpu(cuda):
    """Grad-TTS at cli/params.py's LJSpeech width and HiFi-GAN V1, seeded
    random weights, bench.py's text, 10 Euler steps at bucket 384 on the
    same z: the card's mel within MAE 1e-3 of the CPU's (the JAX package's
    on-chip gate, README), the same lengths and path, the waveforms finite
    and within MAE 1e-3; no hand kernel launches on this path."""
    from tpu_speech_torch.configs import gradtts as cfg
    from tpu_speech_torch.models.grad_tts import GradTTS, synthesize
    from tpu_speech_torch.models.hifigan import Generator
    from tpu_speech_torch.text import intersperse, symbols, text_to_sequence

    seq = intersperse(text_to_sequence(TTS_TEXT), len(symbols))
    x, xl = torch.tensor([seq]), torch.tensor([len(seq)])
    noise = torch.randn(1, 384, cfg.n_feats, generator=torch.Generator().manual_seed(2))
    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    voc = Generator().init_weights(torch.Generator().manual_seed(1)).eval()
    out = {}
    for dev in ("cpu", cuda):
        model.to(dev), voc.to(dev)
        _build.reset_launches()
        with torch.inference_mode():
            _, dec, attn, yl = synthesize(model, x.to(dev), xl.to(dev), 10, 384,
                                          temperature=1.5, length_scale=0.91,
                                          noise=noise.to(dev))
            n = int(yl[0])
            wav = voc(dec[:, :n].transpose(1, 2))
        assert _build.LAUNCHES == _counts()
        out[str(dev)] = (dec[0, :n].cpu(), attn.cpu(), n, wav.cpu())
    (dec_c, attn_c, n_c, wav_c), (dec_g, attn_g, n_g, wav_g) = out.values()
    assert n_c == n_g and 1 < n_c <= 384  # the bucket clips a longer prediction
    assert torch.equal(attn_c, attn_g)
    assert torch.isfinite(dec_g).all() and torch.isfinite(wav_g).all()
    assert (dec_g - dec_c).abs().mean() < 1e-3
    assert wav_g.shape == (1, 1, n_c * 256) and (wav_g - wav_c).abs().mean() < 1e-3


@pytest.mark.parametrize("shape,ties", [((16, 72, 512), False), ((4, 400, 900), False),
                                        ((6, 33, 80), True), ((16, 33, 96), False),
                                        ((3, 1024, 1100), False), ((2, 2000, 3000), False),
                                        ((2, 2500, 2600), False), ((3, 70, 99), False)],
                         ids=["bench_point", "ljspeech_long", "integer_ties", "tx33",
                              "warp_path_v32", "bits_in_device_memory", "block_path",
                              "ty_not_multiple_of_4"])
def test_maximum_path_kernel_equals_plain(cuda, shape, ties):
    """The MAS kernel's path equals maximum_path_plain's bit for bit: mixed
    lengths, one row with Tx = Ty, a row with t_x > t_y, an integer grid full
    of ties; the warp path at V = 2, 4, 16, 32, its decision bits in device
    memory, the block path, unaligned rows (Ty % 4 != 0)."""
    b, t_x, t_y = shape
    g = torch.Generator().manual_seed(t_x)
    value = -torch.rand(b, t_x, t_y, generator=g) * 200.0
    if ties:
        value = value.round()
    x_len = torch.randint(1, t_x + 1, (b,), generator=g)
    y_len = torch.maximum(torch.randint(1, t_y + 1, (b,), generator=g), x_len)
    x_len[0], y_len[0] = t_x, t_y
    x_len[1], y_len[1] = min(t_x, t_y), min(t_x, t_y)
    if b > 2:  # a row with t_x > t_y: an impossible alignment the scan still defines
        x_len[2], y_len[2] = t_x, max(1, t_x // 3)
    mask = ((torch.arange(t_x)[None, :, None] < x_len[:, None, None])
            & (torch.arange(t_y)[None, None, :] < y_len[:, None, None])).float()
    _build.reset_launches()
    path = maximum_path(value.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == _counts(maximum_path=1)
    assert torch.equal(path.cpu(), maximum_path_plain(value, mask))
    assert path.sum().item() == y_len.sum().item()  # one token per valid frame
    if b > 2:  # the kernel's clock stamps: the chains ran and the clock is sane
        stamps = torch.zeros(b, 10, dtype=torch.int64, device=cuda)
        assert torch.equal(maximum_path(value.to(cuda), mask.to(cuda), stamps=stamps).cpu(),
                           maximum_path_plain(value, mask))
        st = stamps.cpu()
        assert (st[:, 4] > st[:, 2]).all() and (st[:, 2] >= st[:, 1]).all()
        assert (st[:, 6] > st[:, 5]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_registered_ops_launch_their_kernels_and_match_plain(cuda, dtype):
    """``tpu_speech::fused_logmel`` (fp32 only), ``::fused_qkv_attention_fwd``
    and ``::grouped_posconv`` on CUDA tensors: each launches its hand kernel
    once (the counters say so) and equals its plain version on the same
    inputs within the kernels' limits (K1 2e-4, K2 1e-4, K4 1e-4 x max(1,
    max|plain|); bf16 8e-3 x max(1, max|plain|)); the fake implementations
    give the kernels' shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(16)
    qkv = (torch.randn(3, 77, 3 * 128, generator=g) * 0.3).to(cuda, dtype)
    mask = torch.zeros(3, 77, dtype=torch.bool)
    mask[1, 50:] = True
    mask = mask.to(cuda)
    x = torch.randn(2, 90, 256, generator=g).to(cuda, dtype)
    w = (torch.randn(256, 32, 17, generator=g) * 0.05).to(cuda, dtype)
    cases = [("fused_qkv_attention", torch.ops.tpu_speech.fused_qkv_attention_fwd,
              (qkv, 4, mask), qkv_attention_plain(qkv, 4, mask), 1e-4),
             ("grouped_conv1d", torch.ops.tpu_speech.grouped_posconv, (x, w, 8, 8),
              grouped_conv1d_plain(x, w, 8, 8), 1e-4)]
    if dtype == torch.float32:
        win, fb = _spiral_consts(cuda)
        wav = torch.randn(2, 16512, generator=g).to(cuda)
        kw = (512, 160, 100, "power", "guard", 2.0 ** -24, 0.0)
        cases.append(("fused_logmel", torch.ops.tpu_speech.fused_logmel, (wav, win, fb) + kw,
                      logmel_plain(wav, win, fb, n_fft=512, hop_length=160, num_frames=100,
                                   mag_eps=0.0), 2e-4))
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    for key, op, args, plain, tol in cases:
        _build.reset_launches()
        got = op(*args)
        torch.cuda.synchronize()
        name = key if key == "fused_logmel" else key + suffix
        assert _build.LAUNCHES == _counts(**{name: 1}), (key, _build.LAUNCHES)
        assert got.dtype == plain.dtype and got.shape == plain.shape
        scale = 1.0 if key == "fused_logmel" else max(1.0, plain.float().abs().max().item())
        bound = 8e-3 if dtype == torch.bfloat16 else tol
        assert (got.float() - plain.float()).abs().max().item() <= bound * scale, key
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        assert fake.shape == got.shape and fake.dtype == got.dtype and fake.device == got.device


def test_load_exported_runs_a_card_program_in_full_fp32(cuda, tmp_path):
    """A program traced on the card and loaded with ``load_exported`` turns
    TF32 off for the process (cuDNN's convolutions and cuBLAS's matmuls), so
    an fp32 conv program equals the eager fp32 conv within 1e-5."""
    from tpu_speech_torch.utils.export import export_fn, load_exported

    g = torch.Generator().manual_seed(46)
    conv = torch.nn.Conv1d(80, 256, 7, padding=3).to(cuda)
    x = torch.randn(4, 80, 384, generator=g).to(cuda)
    path = str(tmp_path / "conv.pt2")
    export_fn(conv, (x,), path)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        art = load_exported(path)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        got = art.call(x)
        with torch.no_grad():
            want = conv(x)
        assert (got - want).abs().max().item() <= 1e-5
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---- the streaming chunk step's shapes and wav2vec 2.0's head width ----------


@pytest.mark.parametrize("b,t,c,g", [(1, 159, 512, 16), (1, 143, 768, 16)])
def test_grouped_conv1d_at_the_chunk_shapes_with_no_left_pad(cuda, b, t, c, g):
    """The streaming positional conv: [tail 127, new C] with left_pad 0, whose
    first C rows are the valid outputs (SPIRAL-base streaming at chunk 128:
    C = 32 at 512 wide, 16 at 768)."""
    gen = torch.Generator().manual_seed(t)
    x = torch.randn(b, t, c, generator=gen).to(cuda)
    w = (torch.randn(c, c // g, 128, generator=gen) * 0.05).to(cuda)
    before = _build.LAUNCHES["grouped_conv1d"]
    out = grouped_conv1d(x, w, g, 0)
    assert _build.LAUNCHES["grouped_conv1d"] == before + 1
    torch.testing.assert_close(out, grouped_conv1d_plain(x, w, g, 0), rtol=0, atol=1e-4)


def test_fused_logmel_on_the_streaming_chunk_window(cuda):
    """K1 on one chunk's window (1, 128 x 160 + 352) -> 128 frames."""
    win, fb = _spiral_consts(cuda)
    x = (torch.randn(1, 128 * 160 + 352, generator=torch.Generator().manual_seed(0)) * 0.1)
    x = x.to(cuda)
    kw = dict(n_fft=512, hop_length=160, num_frames=128)
    out = fused_logmel(x, win, fb, **kw)
    assert out.shape == (1, 128, 128)
    torch.testing.assert_close(out, logmel_plain(x, win, fb, **kw), rtol=0, atol=2e-4)


def test_stream_step_on_the_card_matches_the_cpu(cuda):
    """The tiny streaming model's chunk step, card against CPU on the same
    windows: log-probs within 1e-4; K1 once and K4 once a transformer block
    each chunk, and nothing else."""
    from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel
    from tpu_speech_torch.models.spiral.encoder import (
        ConvLayerCfg, ConvTransformerBlockCfg, StreamingCfg, TransformerCfg)
    from tpu_speech_torch.models.spiral.st2vec import ST2VecConfig
    from tpu_speech_torch.models.spiral.streaming import make_stream_step

    blocks = tuple(ConvTransformerBlockCfg(
        conv_layers=(ConvLayerCfg(w, (5,), (2,), "ln", "relu", 0.0),),
        transformer=TransformerCfg(1, w, 2 * w, 2, 0.0, attention_dropout=0.0, conv_pos=8,
                                   conv_pos_groups=2)) for w in (32, 64))
    cfg = ST2VecConfig(blocks=blocks, num_features=16,
                       streaming=StreamingCfg(chunk_frames=16, left_chunks=2))
    model = CTCFinetuneModel(cfg, 6, decoder_convs=(ConvLayerCfg(16, (5,), (1,), None, "relu",
                                                                 0.0),),
                             upsample_rate=2, upsample_filters=16)
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    wav = torch.randn(1, 3 * 16 * 160 + 512, generator=torch.Generator().manual_seed(1)) * 0.1
    outs = []
    for dev in ("cpu", cuda):
        init_state, step = make_stream_step(model.to(dev))
        st, lps = init_state(1), []
        _build.reset_launches()
        for j in range(3):
            window = wav[:, j * 2560:j * 2560 + 2560 + 352].to(dev)
            st, lp, _, _ = step(st, window, torch.tensor([16]))
            lps.append(lp.cpu())
        outs.append((torch.cat(lps, 1), dict(_build.LAUNCHES)))
    (cpu, cpu_n), (card, card_n) = outs
    assert cpu_n == _counts()
    assert card_n == _counts(fused_logmel=3, grouped_conv1d=6)
    torch.testing.assert_close(card, cpu, rtol=0, atol=1e-4)
