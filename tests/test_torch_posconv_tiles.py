"""PyTorch port, the bf16 grouped positional conv kernel's order of sums (K4
and K4-dx on bf16, ``csrc/fused_posconv_sm90.cu``), emulated on the CPU.

The kernel cannot run here, so this file writes its blocking out in torch:
blocks of 256 output frames (128 at Cg 64) whose window is loaded with
zeros outside [0, T); chunks of KC taps (8 at Cg 16 and 32, 4 at 48, 2 at
64), each summed into fresh fp32 accumulators, tap by tap and within a tap
one wgmma k16 step (16 input channels) at a time, then added to the running
fp32 sum chunk by chunk; taps past K contribute nothing; the output rounded
to bf16 once. The emulation reads the weights in the kernel's layout
(``kernel_weights``, and ``_dx_weights`` for dx at the complementary pad), as
the wrapper hands them to the kernel. It is held to three references, over
Cg 16, 32, 48 and 64, lengths around the 64-frame tiles and the blocks (T
in 1 .. 2 blocks + 1), left pads 0, K//2 - 1, K//2 and K - 1, and K 8, 16
and 128:

- the JAX Pallas kernel in interpret mode, forward and its VJP's dx (K a
  multiple of 128 // Cg, as that kernel needs): within 8e-3 forward and
  1.6e-2 for dx, times max(1, max|ref|) (the limits of
  tests/test_torch_posconv.py::test_bf16_matches_jax_pallas_forward_dx_and_dw);
- ``grouped_conv1d_plain`` (float32 products of the bf16 values, one
  rounding) at the same limits;
- float64 on the same bf16 values: no more than 1.25 times as far (L2) as
  the plain version, give or take 2**-9 of the float64 result's norm.

The JAX kernel takes 6-15 s a call in interpret mode at K = 128, so it is
the reference at one K = 128 case; the others hold K = 128 to the plain
version and float64.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.ops.fused_posconv import grouped_conv1d as jax_grouped_conv1d
from tpu_speech_torch.ops import fused_posconv as fp

jax.config.update("jax_default_matmul_precision", "highest")

FWD_RTOL, GRAD_RTOL = 8e-3, 1.6e-2
F64_FACTOR = 1.25
NWG = 2  # consumer warpgroups a block
SOURCE = Path(fp.__file__).resolve().parent.parent / "csrc" / "fused_posconv_sm90.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: under the suite's six workers a team of
    threads per small op spins on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plan(cg):
    """(taps a chunk, 64-frame tiles a warpgroup) of the kernel at Cg."""
    kc = 8 if cg <= 32 else 4 if cg == 48 else 2
    return kc, 2 if cg <= 48 else 1


def emulate(x, wk, left_pad, chunked=True):
    """The kernel on bf16 x (B, T, C) and kernel-layout weights wk (G, K,
    Cg/8, Cg, 8): (bf16 output, its float32 sums). ``chunked=False`` runs one
    chain of fp32 sums over all taps instead (not the kernel's order)."""
    b, t, c = x.shape
    g, k = wk.shape[0], wk.shape[1]
    cg = c // g
    kc, mw = plan(cg)
    frames = 64 * NWG * mw
    # w[g, tap, o, ci] in float64: the k16 step j reads ci 16j .. 16j + 15
    w = wk.double().permute(0, 1, 3, 2, 4).reshape(g, k, cg, cg)
    n_chunks = math.ceil(k / kc) if chunked else 1
    taps = kc if chunked else k
    sums = torch.zeros(b, t, c, dtype=torch.float32)
    for t0 in range(0, t, frames):  # one block: its window, zeros outside [0, T)
        lo = t0 - left_pad
        window = torch.zeros(b, frames + k - 1, c, dtype=torch.float64)
        src = slice(max(lo, 0), min(lo + frames + k - 1, t))
        window[:, src.start - lo:src.stop - lo] = x[:, src].double()
        window = window.view(b, -1, g, cg)
        acc = torch.zeros(b, frames, g, cg, dtype=torch.float32)
        for ch in range(n_chunks):
            part = torch.zeros_like(acc)  # fresh accumulators for the chunk
            for kk in range(taps):
                tap = ch * taps + kk
                if tap >= k:  # A from the zeros, B zero-filled: adds nothing
                    continue
                a = window[:, tap:tap + frames]  # frame f reads window row f + tap
                for j in range(cg // 16):  # one wgmma k16 step, exact in float64
                    ci = slice(16 * j, 16 * j + 16)
                    step = torch.einsum("bfgi,goi->bfgo", a[..., ci], w[:, tap, :, ci])
                    part = part + step.float()
            acc = acc + part
        n = min(frames, t - t0)
        sums[:, t0:t0 + n] = acc[:, :n].reshape(b, n, c)
    return sums.bfloat16(), sums


def _case(rng, b, t, cg, g, k):
    """bf16 x (B, T, C), w (C, Cg, K) and a cotangent, as float32 of bf16."""
    c = cg * g
    x = torch.tensor(rng.standard_normal((b, t, c)), dtype=torch.float32).bfloat16()
    w = torch.tensor(rng.standard_normal((c, cg, k)) * (cg * k) ** -0.5,
                     dtype=torch.float32).bfloat16()
    dy = torch.tensor(rng.standard_normal((b, t, c)), dtype=torch.float32).bfloat16()
    return x, w, dy


def _jax(x, w, dy, g, left, with_dx):
    """The JAX Pallas kernel in interpret mode on the same bf16 values:
    forward, and dx from its VJP if asked."""
    jx, jc = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (x, dy))
    jw = jnp.asarray(w.float().permute(2, 1, 0).numpy()).astype(jnp.bfloat16)  # (K, Cg, C)
    fwd = lambda xx, ww: jax_grouped_conv1d(xx, ww, g, left, True)  # noqa: E731
    if not with_dx:
        return torch.tensor(np.asarray(fwd(jx, jw).astype(jnp.float32))), None
    out, vjp = jax.vjp(fwd, jx, jw)
    return (torch.tensor(np.asarray(out.astype(jnp.float32))),
            torch.tensor(np.asarray(vjp(jc)[0].astype(jnp.float32))))


def _plain_dx(x, w, dy, g, left):
    xx = x.clone().requires_grad_(True)
    fp.grouped_conv1d_plain(xx, w, g, left).backward(dy)
    return xx.grad


def _f64_dx(x, w, dy, g, left):
    xx = x.double().requires_grad_(True)
    fp.grouped_conv1d_plain(xx, w.double(), g, left).backward(dy.double())
    return xx.grad


def _near(got, ref, rtol, what):
    lim = rtol * max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= lim, (what, err, lim)


def _near_f64(got, plain, exact, what):
    e_got = (got.double() - exact).norm().item()
    e_plain = (plain.double() - exact).norm().item()
    assert e_got <= F64_FACTOR * e_plain + 2**-9 * exact.norm().item(), (what, e_got, e_plain)


# (Cg, groups, B, T, K, left pads held to JAX): T around the 64-frame tiles
# and past two blocks (513 = 2 x 256 + 1 for Cg <= 48, 257 for Cg 64)
CASES = [
    (16, 2, 2, 1, 8, (0, 3)),
    (16, 2, 1, 63, 16, (7, 8)),
    (16, 2, 1, 513, 8, (4, 7)),
    (32, 2, 1, 64, 128, (64,)),
    (32, 2, 1, 65, 16, (0, 15)),
    (32, 2, 1, 129, 8, (3, 4)),
    (32, 1, 2, 513, 16, (8, 15)),
    (48, 2, 1, 127, 128, ()),
    (48, 2, 2, 128, 16, (7, 8)),
    (48, 1, 1, 65, 8, (0, 7)),
    (64, 2, 1, 129, 128, ()),
    (64, 2, 1, 257, 16, (0, 7)),
    (64, 1, 2, 1, 8, (3, 4)),
    (64, 1, 1, 63, 128, ()),
]


@pytest.mark.parametrize("cg,g,b,t,k,jax_pads", CASES)
def test_emulated_kernel_matches_jax_plain_and_float64(rng, cg, g, b, t, k, jax_pads):
    """Forward at left pads 0, K//2 - 1, K//2, K - 1 and dx (the kernel on
    ``_dx_weights`` at K - 1 - left_pad, as the backward launches it) against
    the plain version and float64 at every pad, and against the JAX Pallas
    kernel (its VJP for dx) at ``jax_pads``."""
    x, w, dy = _case(rng, b, t, cg, g, k)
    for left in sorted({0, max(k // 2 - 1, 0), k // 2, k - 1}):
        out, _ = emulate(x, fp.kernel_weights(w, g), left)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
        plain = fp.grouped_conv1d_plain(x, w, g, left)
        _near(out, plain, FWD_RTOL, f"forward vs plain, left {left}")
        _near_f64(out, plain, fp.grouped_conv1d_plain(x.double(), w.double(), g, left),
                  f"forward vs float64, left {left}")
        dx, _ = emulate(dy, fp._dx_weights(w, g), k - 1 - left)
        plain_dx = _plain_dx(x, w, dy, g, left)
        _near(dx, plain_dx, GRAD_RTOL, f"dx vs plain, left {left}")
        _near_f64(dx, plain_dx, _f64_dx(x, w, dy, g, left), f"dx vs float64, left {left}")
        if left in jax_pads:
            ref, ref_dx = _jax(x, w, dy, g, left, with_dx=left == jax_pads[0])
            _near(out, ref, FWD_RTOL, f"forward vs JAX Pallas, left {left}")
            if ref_dx is not None:
                _near(dx, ref_dx, GRAD_RTOL, f"dx vs JAX Pallas VJP, left {left}")


@pytest.mark.parametrize("cg", [32, 48])
def test_emulated_order_is_fixed_and_chunked(rng, cg):
    """Two runs of the emulation give equal bits; its fp32 sums differ from
    one unchunked chain over all taps and from the plain version's, so the
    emulation is the kernel's order and not the plain version renamed."""
    x, w, _ = _case(rng, 2, 200, cg, 2, 128)
    wk = fp.kernel_weights(w, 2)
    out, sums = emulate(x, wk, 64)
    out2, sums2 = emulate(x, wk, 64)
    assert torch.equal(sums, sums2) and torch.equal(out, out2)
    _, chain = emulate(x, wk, 64, chunked=False)
    plain32 = fp.grouped_conv1d_plain(x.float(), w.float(), 2, 64)
    assert not torch.equal(sums, chain)
    assert not torch.equal(sums, plain32)
    _near(out, fp.grouped_conv1d_plain(x, w, 2, 64), FWD_RTOL, "forward vs plain")


def test_emulation_plan_is_the_kernel_source():
    """The blocking emulated here is the one the kernel source declares:
    two consumer warpgroups, KC taps a chunk and MW tiles a warpgroup per
    Cg, as its Plan, tiles_of and its dispatch on C/G say."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int NWG = (\d+);", src).group(1) == str(NWG)
    kc = re.search(r"static constexpr int KC = CG <= 32 \? (\d+) : CG == 48 \? (\d+) : (\d+);",
                   src)
    assert kc is not None
    assert [int(v) for v in kc.groups()] == [plan(16)[0], plan(48)[0], plan(64)[0]]
    assert plan(32)[0] == plan(16)[0]
    mw = re.search(r"constexpr int tiles_of\(int cg\) \{ return cg <= (\d+) \? (\d+) : (\d+); \}",
                   src)
    assert mw is not None
    below, many, few = (int(v) for v in mw.groups())
    for cg in (16, 32, 48, 64):
        assert (many if cg <= below else few) == plan(cg)[1], cg
        m = re.search(rf"case {cg}: return launch<{cg}, tiles_of\({cg}\)>" if cg != 64
                      else r"default: return launch<64, tiles_of\(64\)>", src)
        assert m is not None, cg
