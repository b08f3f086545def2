"""PyTorch port, K2 (merged-qkv attention forward): the plain version against
the JAX Pallas kernel in interpret mode, the wrapper's CPU dispatch, its
argument checks, and the attention module against the JAX module.

The CUDA kernel itself is checked on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral.wav2vec import (
    MultiheadSelfAttention as JaxMultiheadSelfAttention,
)
from tpu_speech.ops.fused_attention import fused_qkv_self_attention as jax_fused_qkv
from tpu_speech_torch.models.spiral.wav2vec import MultiheadSelfAttention
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops.fused_attention import (
    fused_qkv_self_attention,
    qkv_attention_plain,
)

jax.config.update("jax_default_matmul_precision", "highest")


def _qkv(rng, b, t, e, h, fully_padded_row=True):
    qkv = rng.standard_normal((b, t, 3 * e)).astype(np.float32)
    qkv[..., :e] *= (e // h) ** -0.5  # the folded q scale
    lens = rng.integers(max(1, t // 3), t + 1, size=b)
    if fully_padded_row:
        lens[0] = 0
    mask = np.arange(t)[None, :] >= lens[:, None]
    return qkv, mask


@pytest.mark.parametrize("b,t,e,h", [(2, 12, 32, 4), (3, 37, 48, 2), (2, 70, 64, 1)])
def test_plain_matches_jax_pallas_interpret(rng, b, t, e, h):
    qkv, mask = _qkv(rng, b, t, e, h)
    ref = jax_fused_qkv(jnp.asarray(qkv), h, jnp.asarray(mask), interpret=True)
    out = qkv_attention_plain(torch.tensor(qkv), h, torch.tensor(mask))
    assert out.shape == (b, t, e)
    assert torch.isfinite(out[0]).all()  # the fully padded row stays finite
    # the bound tests/test_fused_attention.py:166 uses for the kernel vs XLA
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_plain_without_mask_matches_jax(rng):
    qkv, _ = _qkv(rng, 2, 20, 32, 4)
    ref = jax_fused_qkv(jnp.asarray(qkv), 4, None, interpret=True)
    out = qkv_attention_plain(torch.tensor(qkv), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_fully_padded_row_averages_values(rng):
    """-1e9 (not -inf) at every key: the softmax is uniform, so the row is the
    mean of v over all T keys."""
    b, t, e, h = 1, 9, 16, 2
    qkv, _ = _qkv(rng, b, t, e, h)
    mask = np.ones((b, t), bool)
    out = qkv_attention_plain(torch.tensor(qkv), h, torch.tensor(mask))
    v_mean = qkv[0, :, 2 * e:].mean(axis=0)
    np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(v_mean, (t, e)),
                               rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    qkv, mask = _qkv(rng, 2, 15, 32, 4)
    before = dict(_build.LAUNCHES)
    q, m = torch.tensor(qkv), torch.tensor(mask)
    torch.testing.assert_close(fused_qkv_self_attention(q, 4, m),
                               qkv_attention_plain(q, 4, m), rtol=0, atol=0)
    assert _build.LAUNCHES == before


def test_wrapper_rejects_what_it_does_not_take():
    qkv = torch.zeros(2, 5, 24)
    with pytest.raises(NotImplementedError):  # K2-bwd / dropout not ported yet
        fused_qkv_self_attention(qkv, 2, dropout_p=0.1)
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv, 5)  # 3E not divisible by 3 * heads
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv, 2, torch.zeros(2, 5))  # float mask
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv, 2, torch.zeros(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv.to("meta"), 2)


@pytest.mark.parametrize("jax_fused", [False, True])
def test_multihead_self_attention_matches_jax_module(rng, jax_fused):
    """Same weights in both modules; the JAX side runs its XLA path or its
    Pallas kernel in interpret mode. The port folds d_head**-0.5 into the q
    weight and bias exactly as wav2vec.py:152-155."""
    b, t, e, h = 2, 11, 32, 4
    port = MultiheadSelfAttention(e, h).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    params = {
        name: {"kernel": getattr(port, name).weight.detach().numpy().T,
               "bias": getattr(port, name).bias.detach().numpy()}
        for name in ("q_proj", "k_proj", "v_proj", "out_proj")
    }
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    lens = np.array([t, 6])
    mask = np.arange(t)[None, :] >= lens[:, None]
    jmod = JaxMultiheadSelfAttention(e, h, fused=jax_fused, fused_interpret=jax_fused)
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = port(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
