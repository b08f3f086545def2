"""PyTorch port, the bf16 attention kernels' tile order (K2 and K3 on bf16,
``csrc/fused_attention_sm90.cu``), emulated on the CPU.

The kernels cannot run here, so this file writes their blocking out in
torch: 64-wide key tiles with the online max and rescale of the forward, P~
rounded to bf16 before P~ v; a backward whose dQ sums dS k key tile by key
tile (S and dP recomputed, dS rounded to bf16) and whose dK and dV sum over
query tiles with the keys as rows, from the row logsumexp L and Delta =
rowsum(dO * out) of the bf16 out, a fully padded row (L == -1e9) taken as
uniform. The emulation is held to three references, at lengths around the
tile edges (T in 1 .. 200, one to four key tiles), with a fully padded row,
on the merged (B, T, 3E) plane and on (B, T, H, D) arrays:

- the JAX Pallas kernels in interpret mode at p = 0: forward within 8e-3,
  gradients within 1.6e-2, times max(1, max|ref|) (the limits of
  tests/test_torch_attention.py::test_bf16_plain_matches_jax_pallas_interpret;
  gradients of the batch items with a valid key, where the Pallas backward
  and the port agree, ROADMAP Queue 3);
- ``attention_plain`` at p = 0.1 with the same dropout bits, the same limits;
- float64 on the same bf16 values: no more than 1.25 times as far (L2) as
  the plain version, give or take 2**-9 of the float64 result's norm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.ops.fused_attention import fused_qkv_self_attention as jax_fused_qkv
from tpu_speech.ops.fused_attention import fused_self_attention as jax_fused_attn
from tpu_speech_torch.ops.fused_attention import (
    attention_plain,
    dropout_keep_mask,
    qkv_attention_plain,
)

jax.config.update("jax_default_matmul_precision", "highest")

TILE = 64  # the kernels' tile: 64 query rows a block, 64 keys a tile
FILL = -1e9
LOG2E = 1.4426950408889634
FWD_RTOL, GRAD_RTOL = 8e-3, 1.6e-2
F64_FACTOR = 1.25
SEED = 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: under the suite's six workers a team of
    threads per small op spins on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(x):
    """x rounded to bf16, back in float32."""
    return x.to(torch.bfloat16).float()


def _heads(x):
    """(B, T, H, D) -> (B, H, T, D) float32."""
    return x.float().permute(0, 2, 1, 3)


def _keep_scale(b, h, t, p):
    """keep / (1 - p) of every (b, h, query, key), or the scalar 1."""
    if p == 0.0:
        return torch.tensor(1.0)
    return dropout_keep_mask(SEED, b, h, t, p).float() * (1.0 / (1.0 - p))


def emulate_fwd(q, k, v, mask, p):
    """The forward kernel's blocking on bf16 q, k, v (B, T, H, D): for each
    key tile, S in float32, the -1e9 fill, the online max m and its rescale
    factor alpha = 2^((m_old - m) log2 e), P = 2^((S - m) log2 e), the
    un-dropped row sum l, P~ = P keep / (1 - p) rounded to bf16, out = out
    alpha + P~ v. Returns out (bf16) and L = m + log l (float32)."""
    b, t, h, d = q.shape
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    ks = _keep_scale(b, h, t, p)
    m = torch.full((b, h, t), -float("inf"))
    l = torch.zeros(b, h, t)
    o = torch.zeros(b, h, t, d)
    for k0 in range(0, t, TILE):
        cols = slice(k0, min(k0 + TILE, t))
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        if mask is not None:
            s = s.masked_fill(mask[:, None, None, cols], FILL)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        pr = torch.exp2((s - m_new[..., None]) * LOG2E)
        l = l * alpha + pr.sum(-1)
        pd = pr * (ks[..., cols] if ks.ndim else ks)
        o = o * alpha[..., None] + _bf(pd) @ vf[:, :, cols]
        m = m_new
    out = (o / l[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)
    return out, m + torch.log(l)


def emulate_bwd(q, k, v, mask, p, out, dout, lse):
    """The backward kernels' blocking: Delta from the bf16 out; the dQ
    kernel's key tiles in order (S, dP recomputed; dS rounded to bf16, 0 at
    padded keys; dQ += dS k); the dK/dV kernel's query tiles in order with
    the keys as rows (dV += P~^T dO, dK += dS^T q, P~ and dS in bf16).
    Returns dq, dk, dv (B, T, H, D) bf16."""
    b, t, h, d = q.shape
    qf, kf, vf, of, gf = (_heads(x) for x in (q, k, v, out, dout))
    ks = _keep_scale(b, h, t, p)
    ks = ks if ks.ndim else ks.expand(b, h, t, t)
    delta = (gf * of).sum(-1)  # (B, H, T)
    padded = (torch.zeros(b, t, dtype=torch.bool) if mask is None else mask)[:, None]

    def grads(s, dp, L, dl, kp, key_pad):  # P~ and dS of one tile
        pr = torch.where(L <= FILL, torch.tensor(1.0 / t),
                         torch.exp2(s.masked_fill(key_pad, FILL) * LOG2E - L * LOG2E))
        return pr * kp, (pr * (dp * kp - dl)).masked_fill(key_pad, 0.0)

    dq = torch.zeros(b, h, t, d)
    for k0 in range(0, t, TILE):  # the dQ kernel: queries as rows
        cols = slice(k0, min(k0 + TILE, t))
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        dp = gf @ vf[:, :, cols].transpose(-1, -2)
        _, ds = grads(s, dp, lse[..., None], delta[..., None], ks[..., cols],
                      padded[:, :, None, cols])
        dq = dq + _bf(ds) @ kf[:, :, cols]
    dk, dv = torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    for q0 in range(0, t, TILE):  # the dK/dV kernel: keys as rows
        rows = slice(q0, min(q0 + TILE, t))
        st = kf @ qf[:, :, rows].transpose(-1, -2)
        dpt = vf @ gf[:, :, rows].transpose(-1, -2)
        pd, ds = grads(st, dpt, lse[:, :, None, rows], delta[:, :, None, rows],
                       ks[:, :, rows].transpose(-1, -2), padded[:, :, :, None])
        dv = dv + _bf(pd) @ gf[:, :, rows]
        dk = dk + _bf(ds) @ qf[:, :, rows]
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16) for x in (dq, dk, dv))


def _f64_attention(q, k, v, mask, p):
    """Attention in float64 on the bf16 values, (B, T, H, D)."""
    b, t, h, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.double(), k.double())
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :], FILL)
    pr = torch.softmax(s, -1)
    if p > 0.0:
        pr = pr * dropout_keep_mask(SEED, b, h, t, p) / (1.0 - p)
    return torch.einsum("bhts,bshd->bthd", pr, v.double())


def _close(got, want, rtol, what):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=rtol * max(1.0, want.abs().max().item()),
                               msg=lambda m: f"{what}: {m}")


def _l2(xs, refs):
    return sum((x.double() - r.double()).square().sum().item() for x, r in zip(xs, refs)) ** 0.5


def _case(t, d, seed):
    """bf16 q (scaled), k, v (B=2, T, H=2, D), dout and a key padding mask
    whose first item is fully padded."""
    rng = np.random.default_rng(seed)
    b, h = 2, 2
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    q *= d ** -0.5
    lens = np.array([0, max(1, (2 * t) // 3)])
    mask = torch.tensor(np.arange(t)[None, :] >= lens[:, None])
    return [torch.tensor(x).bfloat16() for x in (q, k, v, g)] + [mask]


def _plain(q, k, v, g, mask, p):
    """attention_plain's bf16 out and dq, dk, dv by autograd."""
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention_plain(*xs, mask, p, SEED)
    out.backward(g)
    return out.detach(), [x.grad for x in xs]


def _f64(q, k, v, g, mask, p):
    xs = [x.double().requires_grad_(True) for x in (q, k, v)]
    out = _f64_attention(*xs, mask, p)
    out.backward(g.double())
    return out.detach(), [x.grad for x in xs]


def _jax_ref(q, k, v, g, mask, merged):
    """The JAX Pallas pair in interpret mode at p = 0 on the same bf16 values:
    out and (dq, dk, dv), each (B, T, H, D) float32."""
    b, t, h, d = q.shape
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    jm = jnp.asarray(mask.numpy())
    if merged:
        plane = torch.stack([q, k, v], 2).reshape(b, t, 3 * h * d)
        ref, vjp = jax.vjp(lambda x: jax_fused_qkv(x, h, jm, interpret=True), to_jax(plane))
        (dplane,) = vjp(to_jax(g.reshape(b, t, h * d)))
        grads = np.asarray(dplane, np.float32).reshape(b, t, 3, h, d)
        return (np.asarray(ref, np.float32).reshape(b, t, h, d),
                [grads[:, :, i] for i in range(3)])
    ref, vjp = jax.vjp(lambda x, y, z: jax_fused_attn(x, y, z, jm, interpret=True),
                       to_jax(q), to_jax(k), to_jax(v))
    return np.asarray(ref, np.float32), [np.asarray(x, np.float32) for x in vjp(to_jax(g))]


# lengths around the 64-row tiles: one to four key tiles and their edges
TILE_T = [1, 63, 64, 65, 127, 128, 129, 200]


@pytest.mark.parametrize("merged", [True, False], ids=["merged_plane", "bthd"])
@pytest.mark.parametrize("t", TILE_T)
def test_tile_emulation_matches_references(t, merged):
    """The emulated kernels against JAX's Pallas pair (p = 0), the plain
    version with the dropout bits replayed (p = 0.1), and float64 on the
    same bf16 values; a fully padded row's dq and dk exactly 0."""
    d = (16, 32, 64)[t % 3]
    q, k, v, g, mask = _case(t, d, 7 * t + merged)
    for p in (0.0, 0.1):
        out, lse = emulate_fwd(q, k, v, mask, p)
        grads = emulate_bwd(q, k, v, mask, p, out, g, lse)
        assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)
        assert lse[0].eq(FILL).all()  # the fully padded item's L is the fill
        for x in grads[:2]:
            assert x[0].abs().max().item() == 0.0
        if p == 0.0:
            ref, ref_grads = _jax_ref(q, k, v, g, mask, merged)
            _close(out, torch.tensor(ref), FWD_RTOL, f"JAX forward T={t}")
            for x, r in zip(grads, ref_grads):  # items with a valid key
                _close(x[1:], torch.tensor(r)[1:], GRAD_RTOL, f"JAX gradient T={t}")
        plain, plain_grads = _plain(q, k, v, g, mask, p)
        _close(out, plain, FWD_RTOL, f"plain forward T={t} p={p}")
        for x, r in zip(grads, plain_grads):
            _close(x, r, GRAD_RTOL, f"plain gradient T={t} p={p}")
        exact, exact_grads = _f64(q, k, v, g, mask, p)
        for got, pl, ex in (([out], [plain], [exact]), (grads, plain_grads, exact_grads)):
            norm = sum(x.square().sum().item() for x in ex) ** 0.5
            assert _l2(got, ex) <= F64_FACTOR * _l2(pl, ex) + 2**-9 * norm, (t, p)


def test_tile_emulation_online_rescale_is_not_a_one_tile_softmax():
    """At T = 200 (four key tiles) the rows whose largest score lies in a
    later tile are rescaled: the emulation still lands on the one-pass
    softmax within bf16 rounding, while skipping the rescale (alpha = 1)
    does not."""
    q, k, v, g, mask = _case(200, 32, 5)
    q = q * 4  # peaked rows: the running max moves between tiles
    out, _ = emulate_fwd(q, k, v, mask, 0.0)
    plain, _ = _plain(q, k, v, g, mask, 0.0)
    _close(out, plain, FWD_RTOL, "rescaled")
    b, t, h, d = q.shape
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    m = torch.full((b, h, t), -float("inf"))
    l, o = torch.zeros(b, h, t), torch.zeros(b, h, t, d)
    for k0 in range(0, t, TILE):  # the same loop without the rescale
        cols = slice(k0, min(k0 + TILE, t))
        s = (qf @ kf[:, :, cols].transpose(-1, -2)).masked_fill(mask[:, None, None, cols], FILL)
        m = torch.maximum(m, s.amax(-1))
        pr = torch.exp2((s - m[..., None]) * LOG2E)
        l, o = l + pr.sum(-1), o + _bf(pr) @ vf[:, :, cols]
    wrong = (o / l[..., None]).permute(0, 2, 1, 3)
    assert (wrong - plain.float()).abs().max().item() > 10 * FWD_RTOL


def test_tile_emulation_backward_order_is_deterministic():
    """The backward sums in a fixed tile order, so running it twice gives the
    same bits, and summing dQ over key tiles (the kernel's order) differs from
    one product over all keys only by float32 rounding."""
    q, k, v, g, mask = _case(129, 64, 3)
    out, lse = emulate_fwd(q, k, v, mask, 0.1)
    first = emulate_bwd(q, k, v, mask, 0.1, out, g, lse)
    second = emulate_bwd(q, k, v, mask, 0.1, out, g, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    plain_out = qkv_attention_plain(torch.stack([q, k, v], 2).reshape(2, 129, -1), 2, mask,
                                    0.1, SEED)
    _close(out.reshape(2, 129, -1), plain_out, FWD_RTOL, "merged plain")
