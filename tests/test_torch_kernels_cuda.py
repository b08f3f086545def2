"""PyTorch port, the hand-written Hopper kernels against their plain versions.

Marked ``cuda``: each test needs a CUDA card and nvcc and skips without them
(the card is checked inside the fixture, never at import). This file imports
no JAX; on a CUDA machine without JAX run it past tests/conftest.py (which
imports JAX):  ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.
Inputs are fp32 with TF32 off.
"""

import numpy as np
import pytest
import torch

from tpu_speech_torch.audio.mel import hann_window, mel_filterbank
from tpu_speech_torch.models.spiral.features import hann_window_symmetric
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops.fused_attention import (
    KERNEL_D_HEADS,
    fused_qkv_self_attention,
    qkv_attention_plain,
)
from tpu_speech_torch.ops.fused_logmel import fused_logmel, logmel_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return torch.device("cuda")


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


def test_launch_counters_count_kernel_launches_only(cuda):
    win, fb = _spiral_consts(cuda)
    _build.reset_launches()
    x = torch.randn(1, 2000)
    fused_logmel(x, win.cpu(), fb.cpu(), n_fft=512, hop_length=160, num_frames=9)
    fused_qkv_self_attention(torch.randn(1, 4, 48), 2)
    assert _build.LAUNCHES == {"fused_logmel": 0, "fused_qkv_attention": 0}
    fused_logmel(x.to(cuda), win, fb, n_fft=512, hop_length=160, num_frames=9)
    fused_qkv_self_attention(torch.randn(1, 4, 48, device=cuda), 2)
    fused_qkv_self_attention(torch.randn(1, 4, 48, device=cuda), 2)
    assert _build.LAUNCHES == {"fused_logmel": 1, "fused_qkv_attention": 2}


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    qkv = torch.randn(1, 4, 48, device=cuda)
    with pytest.raises(NotImplementedError):
        fused_qkv_self_attention(qkv, 2, dropout_p=0.1)
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv.double(), 2)
    with pytest.raises(ValueError):
        fused_qkv_self_attention(torch.randn(1, 4, 3 * 40, device=cuda), 1)  # d_head 40
    win, fb = _spiral_consts(cuda)
    with pytest.raises(ValueError):
        fused_logmel(torch.randn(1, 2000, device=cuda).double(), win, fb,
                     n_fft=512, hop_length=160, num_frames=9)
    with pytest.raises(ValueError):
        fused_logmel(torch.randn(1, 2000, device=cuda), win, fb,
                     n_fft=512, hop_length=162, num_frames=9)


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
    assert _build.LAUNCHES == {"fused_logmel": 1, "fused_qkv_attention": 2}
    torch.testing.assert_close(out_lens.cpu(), ref_lens)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-3)
