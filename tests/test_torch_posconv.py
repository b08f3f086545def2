"""PyTorch port, K4 (the grouped positional conv): the port's
``grouped_conv1d`` (its plain version on the CPU) against the JAX Pallas
kernel in interpret mode and against ``lax.conv_general_dilated``, forward
and gradients, over the shape family of tests/test_fused_posconv.py plus
Cg 32; the dx formula the CUDA path uses; the wrapper's CPU dispatch and
argument checks; and ``ConvPositionalEmbedding`` against the JAX module.

The CUDA kernel itself is checked on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from tpu_speech.models.spiral import wav2vec as jw2v
from tpu_speech.ops.fused_posconv import grouped_conv1d as jax_grouped_conv1d
from tpu_speech_torch.models.spiral.wav2vec import ConvPositionalEmbedding
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops import fused_posconv as fp

jax.config.update("jax_default_matmul_precision", "highest")

# (B, T, C, groups, K, causal): tests/test_fused_posconv.py's family (Cg 16
# and 48, K 8 and 16, SAME-even and causal, T not a multiple of 8) plus Cg 32
SHAPES = [
    (2, 24, 64, 4, 16, False),
    (2, 24, 64, 4, 16, True),
    (1, 40, 96, 2, 16, False),
    (3, 17, 64, 4, 8, False),
    (2, 21, 128, 4, 8, True),
]


def _case(rng, b, t, c, g, k):
    """x (B, T, C); the JAX weight (K, Cg, C) HIO and the port's (C, Cg, K)."""
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    wj = (rng.standard_normal((k, c // g, c)) * 0.1).astype(np.float32)
    return x, wj, np.ascontiguousarray(np.transpose(wj, (2, 1, 0)))


def _lax(x, w, g, left, k):
    return lax.conv_general_dilated(
        x, w, (1,), [(left, k - 1 - left)],
        dimension_numbers=("NHC", "HIO", "NHC"), feature_group_count=g)


@pytest.mark.parametrize("b,t,c,g,k,causal", SHAPES)
def test_forward_matches_jax_pallas_and_lax(rng, b, t, c, g, k, causal):
    x, wj, wt = _case(rng, b, t, c, g, k)
    left = k - 1 if causal else k // 2
    pallas = jax_grouped_conv1d(jnp.asarray(x), jnp.asarray(wj), g, left, True)
    ref = _lax(jnp.asarray(x), jnp.asarray(wj), g, left, k)
    out = fp.grouped_conv1d(torch.tensor(x), torch.tensor(wt), g, left)
    assert out.shape == (b, t, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,t,c,g,k,causal", SHAPES)
def test_gradients_match_jax_grad(rng, b, t, c, g, k, causal):
    """dx and dw of the port against jax.grad through the Pallas kernel's
    custom VJP (dx by the same kernel, dw by XLA). Tolerance 2e-4."""
    x, wj, wt = _case(rng, b, t, c, g, k)
    cot = rng.standard_normal((b, t, c)).astype(np.float32)
    left = k - 1 if causal else k // 2

    def loss(xx, ww):
        return jnp.sum(jax_grouped_conv1d(xx, ww, g, left, True) * jnp.asarray(cot))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wj))
    xt = torch.tensor(x, requires_grad=True)
    wtt = torch.tensor(wt, requires_grad=True)
    fp.grouped_conv1d(xt, wtt, g, left).backward(torch.tensor(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.transpose(wtt.grad.numpy(), (2, 1, 0)), np.asarray(gw),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("b,t,c,g,k,causal", SHAPES)
def test_dx_is_the_forward_on_flipped_swapped_weights(rng, b, t, c, g, k, causal):
    """The CUDA backward's dx: the forward conv of dy with ``_dx_weights``
    and left pad K - 1 - left_pad, written here through the plain version
    and the kernel-layout weights, equals autograd of the plain version."""
    x, _, wt = _case(rng, b, t, c, g, k)
    dy = torch.tensor(rng.standard_normal((b, t, c)).astype(np.float32))
    left = k - 1 if causal else k // 2
    xt = torch.tensor(x, requires_grad=True)
    fp.grouped_conv1d_plain(xt, torch.tensor(wt), g, left).backward(dy)
    wk = fp._dx_weights(torch.tensor(wt), g)  # (G, K, Cg_in, Cg_out) of dx
    w_dx = wk.permute(0, 3, 2, 1).reshape(c, c // g, k)  # back to (C, Cg, K)
    dx = fp.grouped_conv1d_plain(dy, w_dx, g, k - 1 - left)
    torch.testing.assert_close(dx, xt.grad, rtol=0, atol=1e-5)


def test_kernel_weight_layout():
    """kernel_weights(w)[g, k, ci, co] == w[g*Cg + co, ci, k]."""
    c, g, k = 12, 3, 5
    w = torch.arange(c * (c // g) * k, dtype=torch.float32).view(c, c // g, k)
    wk = fp.kernel_weights(w, g)
    assert wk.shape == (g, k, c // g, c // g) and wk.is_contiguous()
    cg = c // g
    for gi, ki, ci, co in ((0, 0, 0, 0), (1, 4, 2, 3), (2, 3, 1, 0)):
        assert wk[gi, ki, ci, co] == w[gi * cg + co, ci, ki]


def test_wrapper_on_cpu_is_the_plain_version(rng):
    x, _, wt = _case(rng, 2, 19, 32, 4, 8)
    before = dict(_build.LAUNCHES)
    xt, wtt = torch.tensor(x), torch.tensor(wt)
    torch.testing.assert_close(fp.grouped_conv1d(xt, wtt, 4, 4),
                               fp.grouped_conv1d_plain(xt, wtt, 4, 4), rtol=0, atol=0)
    assert _build.LAUNCHES == before


def test_wrapper_rejects_what_it_does_not_take():
    x, w = torch.zeros(2, 9, 16), torch.zeros(16, 4, 8)
    with pytest.raises(ValueError):
        fp.grouped_conv1d(x, w, 4, 8)  # left_pad must be < K
    with pytest.raises(ValueError):
        fp.grouped_conv1d(x, w, 4, -1)
    with pytest.raises(ValueError):
        fp.grouped_conv1d(x, w, 2, 4)  # w is not (C, C/groups, K)
    with pytest.raises(ValueError):
        fp.grouped_conv1d(x[0], w, 4, 4)
    with pytest.raises(ValueError):
        fp.grouped_conv1d(x.to("meta"), w.to("meta"), 4, 4)


@pytest.mark.parametrize("k", [16, 15])
def test_conv_positional_embedding_matches_jax_module(rng, k):
    """The JAX module's weights (v (K, Cg, C), g (K,), bias) converted to the
    port's weight_v (C, Cg, K) and weight_g (1, 1, K). Tolerance 1e-5."""
    b, t, c, g = 2, 23, 64, 4
    v = (rng.standard_normal((k, c // g, c)) * 0.2).astype(np.float32)
    gmag = (rng.uniform(0.5, 1.5, size=k)).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    ref = jw2v.ConvPositionalEmbedding(c, k, g).apply(
        {"params": {"v": v, "g": gmag, "bias": bias}}, jnp.asarray(x))
    port = ConvPositionalEmbedding(c, k, g)
    with torch.no_grad():
        port.weight_v.copy_(torch.tensor(np.transpose(v, (2, 1, 0))))
        port.weight_g.copy_(torch.tensor(gmag).view(1, 1, k))
        port.bias.copy_(torch.tensor(bias))
        out = port(torch.tensor(x))
    assert out.shape == (b, t, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_positional_conv_parameters_are_initialised():
    """A fresh module holds the reference init, not uninitialised memory:
    weight_v ~ normal(0, sqrt(4 / (K * C))), weight_g its per-tap norm, zero
    bias, and a forward gives finite output."""
    torch.manual_seed(0)
    m = ConvPositionalEmbedding(64, 16, 4)
    v = m.weight_v.detach()
    assert torch.isfinite(v).all() and not m.bias.any()
    assert abs(v.std().item() / m.init_std() - 1.0) < 0.05
    torch.testing.assert_close(m.weight_g.detach(),
                               v.square().sum(dim=(0, 1), keepdim=True).sqrt())
    out = m(torch.randn(2, 9, 64))
    assert torch.isfinite(out).all()


# ---- bf16 ---------------------------------------------------------------------

@pytest.mark.parametrize("b,t,c,g,k,causal", SHAPES)
def test_bf16_matches_jax_pallas_forward_dx_and_dw(rng, b, t, c, g, k, causal):
    """bf16 x and w through the port (its plain version: float32 products of
    the bf16 values, one rounding to bf16) and through the JAX Pallas kernel
    in interpret mode and its VJP (dx by the same kernel, dw by XLA's bf16
    conv): the output, dx and dw. Limits 8e-3 (forward) and 1.6e-2
    (gradients) times max(1, max|ref|): about one bf16 step."""
    x, wj, _ = _case(rng, b, t, c, g, k)
    cot = rng.standard_normal((b, t, c)).astype(np.float32)
    left = k - 1 if causal else k // 2
    xb, wb, cb = (torch.tensor(a).bfloat16() for a in (x, wj, cot))
    jx, jw, jc = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (xb, wb, cb))
    ref, vjp = jax.vjp(lambda xx, ww: jax_grouped_conv1d(xx, ww, g, left, True), jx, jw)
    gx, gw = vjp(jc)
    xt = xb.clone().requires_grad_(True)
    wt = wb.permute(2, 1, 0).contiguous().requires_grad_(True)  # (C, Cg, K)
    out = fp.grouped_conv1d(xt, wt, g, left)
    out.backward(cb)
    assert out.dtype == xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    for got, want, lim in ((out.detach(), ref, 8e-3), (xt.grad, gx, 1.6e-2),
                           (wt.grad.permute(2, 1, 0), gw, 1.6e-2)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=lim * max(1.0, np.abs(want).max()))


def test_bf16_kernel_weight_layout():
    """The bf16 kernel reads (G, K, Cg_out, Cg_in): kernel_weights(w)[g, k,
    co, ci] == w[g*Cg + co, ci, k]; dx's weights swap the two and flip k."""
    c, g, k = 12, 3, 5
    w = torch.arange(c * (c // g) * k, dtype=torch.float32).view(c, c // g, k).bfloat16()
    wk, wd = fp.kernel_weights(w, g), fp._dx_weights(w, g)
    cg = c // g
    for gi, ki, co, ci in ((0, 0, 0, 0), (1, 4, 2, 3), (2, 3, 1, 0)):
        assert wk[gi, ki, co, ci] == w[gi * cg + co, ci, ki]
        assert wd[gi, ki, ci, co] == w[gi * cg + co, ci, k - 1 - ki]
