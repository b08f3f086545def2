"""PyTorch port, K2 (merged-qkv attention, forward and backward) and K3
(attention on separate (B, T, H, D) q, k, v): the plain versions and their
autograd gradients against the JAX Pallas kernels in interpret mode, the
dropout mask's definition and replay, the gradient at a fully padded row
against the JAX XLA path, the wrappers' CPU dispatch, their argument checks,
and the attention module against the JAX module.

The CUDA kernels themselves are checked on the card by
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
from tpu_speech.ops.fused_attention import fused_self_attention as jax_fused_attn
from tpu_speech_torch.models.spiral.wav2vec import MultiheadSelfAttention
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops.fused_attention import (
    attention_plain,
    dropout_bits,
    dropout_keep_mask,
    fused_qkv_self_attention,
    fused_self_attention,
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
    with pytest.raises(ValueError):  # dropout needs a seed
        fused_qkv_self_attention(qkv, 2, dropout_p=0.1)
    with pytest.raises(ValueError):
        fused_qkv_self_attention(qkv, 2, dropout_p=1.0, dropout_seed=1)
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


@pytest.mark.parametrize("b,t,e,h", [(2, 12, 32, 4), (3, 37, 48, 2), (2, 70, 64, 1)])
def test_plain_gradient_matches_jax_pallas_interpret(rng, b, t, e, h):
    """dqkv by autograd of the plain version against jax.vjp of the Pallas
    kernel pair (K2-fwd/K2-bwd, interpret mode) at dropout 0, over rows that
    have a valid key. Tolerance 1e-5."""
    qkv, mask = _qkv(rng, b, t, e, h, fully_padded_row=False)
    dout = rng.standard_normal((b, t, e)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_qkv(x, h, jnp.asarray(mask), interpret=True),
                     jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(dout))
    x = torch.tensor(qkv, requires_grad=True)
    qkv_attention_plain(x, h, torch.tensor(mask)).backward(torch.tensor(dout))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_fully_padded_row_gradient_is_the_xla_path(rng):
    """At a batch row whose keys are all padded, the plain version's dqkv
    (autograd through masked_fill) equals the gradient of the JAX XLA path
    (wav2vec.py:197-216, through jnp.where): zero into q and k, the uniform
    1/T weights into v. The JAX Pallas backward gives a nonzero dq, dk there
    (it leaves dS = P (dP - Delta) at padded keys); ROADMAP Queue 3 logs the
    difference between the reference's two paths."""
    b, t, e, h = 2, 9, 16, 2
    qkv, mask = _qkv(rng, b, t, e, h, fully_padded_row=True)
    dout = rng.standard_normal((b, t, e)).astype(np.float32)

    def xla(x):  # the XLA path of MultiheadSelfAttention on the merged plane
        q, k, v = jnp.split(x, 3, axis=-1)
        q, k, v = (a.reshape(b, t, h, e // h) for a in (q, k, v))
        s = jnp.einsum("bthd,bshd->bhts", q, k)
        s = jnp.where(jnp.asarray(mask)[:, None, None, :], -1e9, s)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhts,bshd->bthd", p, v).reshape(b, t, e)

    (ref,) = jax.vjp(xla, jnp.asarray(qkv))[1](jnp.asarray(dout))
    x = torch.tensor(qkv, requires_grad=True)
    qkv_attention_plain(x, h, torch.tensor(mask)).backward(torch.tensor(dout))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert not x.grad[0, :, :2 * e].any()  # dq, dk of the fully padded row
    (pallas,) = jax.vjp(lambda y: jax_fused_qkv(y, h, jnp.asarray(mask), interpret=True),
                        jnp.asarray(qkv))[1](jnp.asarray(dout))
    assert np.abs(np.asarray(pallas)[0, :, :2 * e]).max() > 1e-3
    np.testing.assert_allclose(np.asarray(pallas)[1], np.asarray(ref)[1], atol=1e-5, rtol=1e-5)


def _bits_uint32(seed, bh, idx):
    """The kernels' dropout bits, written with Python ints mod 2**32."""
    m = 0xFFFFFFFF

    def fmix(x):
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & m
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & m
        return x ^ (x >> 16)

    stream = fmix(seed ^ fmix((bh + 0x9E3779B9) & m))
    return fmix(stream ^ ((idx * 0x9E3779B1) & m))


def test_dropout_bits_are_the_kernels_definition():
    bh = [0, 1, 95, 287]
    idx = [0, 1, 455, 207935]
    for seed in (0, 1, 2**31 - 2):
        got = dropout_bits(seed, torch.tensor(bh)[:, None], torch.tensor(idx)[None, :])
        want = [[_bits_uint32(seed, a, i) for i in idx] for a in bh]
        assert got.tolist() == want


def test_dropout_mask_rate_and_streams():
    """keep rate within 4 sigma of 1 - p; the mask differs across seeds and
    across (b, h); p = 0.5 and 0.1."""
    for p in (0.1, 0.5):
        keep = dropout_keep_mask(123, 3, 4, 64, p)
        n = keep.numel()
        assert abs(keep.float().mean().item() - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5
        assert (keep[0, 0] != keep[0, 1]).any() and (keep[0, 0] != keep[1, 0]).any()
        assert (keep != dropout_keep_mask(124, 3, 4, 64, p)).any()


def test_dropout_replays_the_same_mask_in_forward_and_backward(rng):
    """The plain forward with dropout equals softmax * keep / (1 - p) @ v for
    the mask dropout_keep_mask defines, and its autograd gradient equals the
    gradient of that explicit expression: the backward replays the
    forward's mask."""
    b, t, e, h, p, seed = 2, 11, 16, 2, 0.1, 77
    qkv, mask = _qkv(rng, b, t, e, h)
    dout = torch.tensor(rng.standard_normal((b, t, e)).astype(np.float32))
    keep = dropout_keep_mask(seed, b, h, t, p)

    def explicit(x):
        q, k, v = x.view(b, t, 3, h, e // h).unbind(2)
        s = torch.einsum("bthd,bshd->bhts", q, k).masked_fill(
            torch.tensor(mask)[:, None, None, :], -1e9)
        pr = torch.softmax(s, dim=-1) * keep / (1 - p)
        return torch.einsum("bhts,bshd->bthd", pr, v).reshape(b, t, e)

    grads, outs = [], []
    for fn in (lambda x: fused_qkv_self_attention(x, h, torch.tensor(mask), p, seed),
               explicit):
        x = torch.tensor(qkv, requires_grad=True)
        out = fn(x)
        out.backward(dout)
        outs.append(out.detach())
        grads.append(x.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)
    assert not torch.allclose(outs[0], qkv_attention_plain(torch.tensor(qkv), h,
                                                           torch.tensor(mask)))


# ---- K3: separate (B, T, H, D) q, k, v --------------------------------------

def _qkv4(rng, b, t, h, d, fully_padded_row=True):
    """q (pre-scaled), k, v (B, T, H, D) and a key padding mask."""
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    q *= d ** -0.5
    lens = rng.integers(max(1, t // 3), t + 1, size=b)
    if fully_padded_row:
        lens[0] = 0
    return q, k, v, np.arange(t)[None, :] >= lens[:, None]


@pytest.mark.parametrize("b,t,h,d", [(2, 12, 4, 8), (3, 37, 2, 24), (2, 70, 1, 64)])
def test_k3_plain_matches_jax_pallas_interpret(rng, b, t, h, d):
    q, k, v, mask = _qkv4(rng, b, t, h, d)
    ref = jax_fused_attn(*map(jnp.asarray, (q, k, v, mask)), interpret=True)
    out = attention_plain(*map(torch.tensor, (q, k, v, mask)))
    assert out.shape == (b, t, h, d)
    assert torch.isfinite(out[0]).all()  # the fully padded row stays finite
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,t,h,d", [(2, 12, 4, 8), (3, 37, 2, 24), (2, 70, 1, 64)])
def test_k3_plain_gradient_matches_jax_pallas_interpret(rng, b, t, h, d):
    """dq, dk, dv by autograd of the plain version against jax.vjp of the
    Pallas K3-fwd/K3-bwd pair (interpret mode) at dropout 0, over rows that
    have a valid key. Tolerance 1e-5."""
    q, k, v, mask = _qkv4(rng, b, t, h, d, fully_padded_row=False)
    dout = rng.standard_normal((b, t, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, y, z: jax_fused_attn(x, y, z, jnp.asarray(mask),
                                                    interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(dout))
    xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    attention_plain(*xs, torch.tensor(mask)).backward(torch.tensor(dout))
    for x, ref in zip(xs, refs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_k3_fully_padded_row_gradient_is_the_xla_path(rng):
    """At a row whose keys are all padded the plain version (and the CUDA
    kernels) give the XLA path's gradient: zero dq and dk, uniform weights
    into dv. The Pallas K3 backward leaves dq and dk nonzero there, as the
    Pallas K2 does (ROADMAP Queue 3); the other rows agree."""
    b, t, h, d = 2, 9, 2, 8
    q, k, v, mask = _qkv4(rng, b, t, h, d, fully_padded_row=True)
    dout = rng.standard_normal((b, t, h, d)).astype(np.float32)

    def xla(x, y, z):
        s = jnp.einsum("bthd,bshd->bhts", x, y)
        s = jnp.where(jnp.asarray(mask)[:, None, None, :], -1e9, s)
        return jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, axis=-1), z)

    refs = jax.vjp(xla, *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(dout))
    xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    attention_plain(*xs, torch.tensor(mask)).backward(torch.tensor(dout))
    for x, ref in zip(xs, refs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert not xs[0].grad[0].any() and not xs[1].grad[0].any()
    pallas = jax.vjp(lambda x, y, z: jax_fused_attn(x, y, z, jnp.asarray(mask),
                                                    interpret=True),
                     *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(dout))
    assert np.abs(np.asarray(pallas[0])[0]).max() > 1e-3
    for got, ref in zip(pallas, refs):
        np.testing.assert_allclose(np.asarray(got)[1], np.asarray(ref)[1], atol=1e-5, rtol=1e-5)


def test_merged_plain_is_k3_plain_on_the_thirds(rng):
    """K2's plain version is K3's on the (B, T, H, D) views of the plane's
    thirds, with dropout: the same function by strides."""
    b, t, e, h = 2, 13, 32, 4
    qkv, mask = _qkv(rng, b, t, e, h)
    x, m = torch.tensor(qkv), torch.tensor(mask)
    q, k, v = (x[..., i * e:(i + 1) * e].reshape(b, t, h, e // h) for i in range(3))
    torch.testing.assert_close(
        qkv_attention_plain(x, h, m, 0.1, 9),
        attention_plain(q, k, v, m, 0.1, 9).reshape(b, t, e), rtol=0, atol=0)


def test_k3_wrapper_on_cpu_is_the_plain_version(rng):
    q, k, v, mask = (torch.tensor(a) for a in _qkv4(rng, 2, 15, 4, 8))
    before = dict(_build.LAUNCHES)
    torch.testing.assert_close(fused_self_attention(q, k, v, mask, 0.1, 3),
                               attention_plain(q, k, v, mask, 0.1, 3), rtol=0, atol=0)
    assert _build.LAUNCHES == before


def test_k3_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros(2, 5, 2, 8)
    with pytest.raises(ValueError):  # dropout needs a seed
        fused_self_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError):
        fused_self_attention(q, q, q, dropout_p=1.0, dropout_seed=1)
    with pytest.raises(ValueError):
        fused_self_attention(q, q[:, :4], q)  # shapes differ
    with pytest.raises(ValueError):
        fused_self_attention(q, q, q, torch.zeros(2, 5))  # float mask
    with pytest.raises(ValueError):
        fused_self_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# ---- why the CUDA kernels split each operand in three TF32 products ---------

def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
    the kernels' hi part."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """x as the tensor core reads a non-TF32 operand: low 13 bits dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_exact_then_f32(a, b):
    # products of TF32 values are exact in float64; one rounding to float32
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _mm_3xtf32(a, b):
    """a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32, a = a_hi + a_lo."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (_mm_exact_then_f32(al, bh) + _mm_exact_then_f32(ah, bl)
            + _mm_exact_then_f32(ah, bh))


def _mm_1xtf32(a, b):
    return _mm_exact_then_f32(_tf32_rna(a), _tf32_rna(b))


def _attention_np(q, k, v, mm, dtype):
    s = mm(q, np.swapaxes(k, -1, -2)).astype(dtype)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(dtype)
    return mm(p, v)


def test_3xtf32_split_keeps_fp32_accuracy_where_one_tf32_pass_does_not():
    """The kernels' products, emulated in numpy at (B, H, T, D) = (2, 2, 64,
    64): the 3xTF32 split lands within 1e-6 (relative to max|out|) of the
    fp32 computation, while one TF32 pass is off by more than the kernels'
    1e-4 limit. This is why the kernels pay three tensor-core products for
    each one."""
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((2, 2, 64, 64)) * 64 ** -0.5).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 64, 64)).astype(np.float32) for _ in range(2))
    exact = _attention_np(q, k, v, lambda a, b: a.astype(np.float64) @ b.astype(np.float64),
                          np.float64)
    fp32 = _attention_np(q, k, v, np.matmul, np.float32)
    split = _attention_np(q, k, v, _mm_3xtf32, np.float32)
    single = _attention_np(q, k, v, _mm_1xtf32, np.float32)
    scale = np.abs(fp32).max()
    assert np.abs(split - fp32).max() <= 1e-6 * scale
    assert np.abs(split - exact).max() <= np.abs(fp32 - exact).max()
    assert np.abs(single - fp32).max() > 1e-4


# ---- bf16: the plain versions round where the Pallas kernels cast ----------

def _bf16(a):
    """numpy float32 -> the bf16 values, as JAX and torch arrays."""
    t = torch.tensor(a).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) else x.float().numpy()


@pytest.mark.parametrize("b,t,e,h", [(2, 12, 32, 4), (3, 37, 48, 2), (2, 70, 64, 1)])
def test_bf16_plain_matches_jax_pallas_interpret(rng, b, t, e, h):
    """bf16 qkv through the plain version and through the JAX Pallas K2 pair
    (interpret mode), dropout 0: the output, and dqkv by autograd against
    jax.vjp (rows with a valid key). Both take the products in float32 from
    the bf16 values, round P to bf16 before P v and dS before dQ and dK, and
    return bf16. Limits: forward 8e-3, gradient 1.6e-2, times max(1,
    max|ref|): about one bf16 step at the largest value."""
    qkv, mask = _qkv(rng, b, t, e, h, fully_padded_row=False)
    dout = rng.standard_normal((b, t, e)).astype(np.float32)
    (jq, tq), (jd, td) = _bf16(qkv), _bf16(dout)
    ref, vjp = jax.vjp(lambda x: jax_fused_qkv(x, h, jnp.asarray(mask), interpret=True), jq)
    (gref,) = vjp(jd)
    x = tq.clone().requires_grad_(True)
    out = qkv_attention_plain(x, h, torch.tensor(mask))
    out.backward(td)
    assert out.dtype == x.grad.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    for got, want, lim in ((out.detach(), ref, 8e-3), (x.grad, gref, 1.6e-2)):
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=lim * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("b,t,h,d", [(2, 12, 4, 16), (3, 37, 2, 32), (2, 70, 1, 64)])
def test_k3_bf16_plain_matches_jax_pallas_interpret(rng, b, t, h, d):
    """K3's plain version on bf16 q, k, v against the JAX Pallas K3 pair in
    interpret mode, dropout 0, forward and dq, dk, dv; the limits of the K2
    test."""
    q, k, v, mask = _qkv4(rng, b, t, h, d, fully_padded_row=False)
    dout = rng.standard_normal((b, t, h, d)).astype(np.float32)
    pairs = [_bf16(a) for a in (q, k, v, dout)]
    ref, vjp = jax.vjp(lambda x, y, z: jax_fused_attn(x, y, z, jnp.asarray(mask),
                                                      interpret=True),
                       *(p[0] for p in pairs[:3]))
    grefs = vjp(pairs[3][0])
    xs = [p[1].clone().requires_grad_(True) for p in pairs[:3]]
    out = attention_plain(*xs, torch.tensor(mask))
    out.backward(pairs[3][1])
    assert out.dtype == torch.bfloat16
    for got, want, lim in [(out.detach(), ref, 8e-3)] + [
            (x.grad, g, 1.6e-2) for x, g in zip(xs, grefs)]:
        want = _f32(want)
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=lim * max(1.0, np.abs(want).max()))


def test_bf16_plain_rounds_p_and_ds_where_the_kernels_do(rng):
    """The bf16 plain version against its definition written out in float32:
    P~ rounded to bf16 before P~ v, the output rounded, and in the backward
    the row sums Delta from the bf16 output (the kernels' Delta kernel) and
    dS rounded to bf16 before dQ and dK (dV from the rounded P~). Equal to
    1e-6; and at these inputs the rounding of dS shows (it is not the
    float32 gradient)."""
    b, t, e, h = 2, 19, 32, 2
    qkv, mask = _qkv(rng, b, t, e, h, fully_padded_row=False)
    d = e // h
    x = torch.tensor(qkv).bfloat16()
    dout = torch.tensor(rng.standard_normal((b, t, e)).astype(np.float32)).bfloat16()
    m = torch.tensor(mask)
    xa = x.clone().requires_grad_(True)
    out = qkv_attention_plain(xa, h, m)
    out.backward(dout)

    q, k, v = (a.float() for a in x.view(b, t, 3, h, d).unbind(2))
    s = torch.einsum("bthd,bshd->bhts", q, k).masked_fill(m[:, None, None, :], -1e9)
    p = torch.softmax(s, -1)
    pb = p.bfloat16().float()
    o = torch.einsum("bhts,bshd->bthd", pb, v).reshape(b, t, e)
    torch.testing.assert_close(out.float(), o.bfloat16().float(), rtol=0, atol=1e-6)
    do = dout.float().view(b, t, h, d)
    dp = torch.einsum("bthd,bshd->bhts", do, v)
    delta = (do * out.float().view(b, t, h, d)).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    ds = ds.masked_fill(m[:, None, None, :], 0.0)
    dq = torch.einsum("bhts,bshd->bthd", ds.bfloat16().float(), k)
    dk = torch.einsum("bhts,bthd->bshd", ds.bfloat16().float(), q)
    dv = torch.einsum("bhts,bthd->bshd", pb, do)
    want = torch.cat([a.reshape(b, t, e) for a in (dq, dk, dv)], -1).bfloat16().float()
    torch.testing.assert_close(xa.grad.float(), want, rtol=0, atol=1e-6)
    unrounded = torch.einsum("bhts,bshd->bthd", ds, k).reshape(b, t, e).bfloat16().float()
    assert not torch.equal(xa.grad.float()[..., :e], unrounded)


def test_kernel_args_take_bf16_at_their_head_widths():
    """What the CUDA path takes, checked before any launch: float32 at
    d_head 8, 16, 32, 64; bf16 at 16, 32, 64; nothing else."""
    from tpu_speech_torch.ops.fused_attention import _kernel_args

    for dtype, d, ok in ((torch.float32, 8, True), (torch.bfloat16, 64, True),
                         (torch.bfloat16, 16, True), (torch.bfloat16, 8, False),
                         (torch.float16, 64, False), (torch.float32, 24, False)):
        x = torch.zeros(1, 2, 3 * d, dtype=dtype)
        if ok:
            assert _kernel_args(x, d, None, 0.0, None, "k")[1:] == (0, 0, 1.0)
        else:
            with pytest.raises(ValueError, match="bfloat16"):
                _kernel_args(x, d, None, 0.0, None, "k")
