"""PyTorch port, Grad-TTS training: the port against the JAX package.

At ``tests/test_train_gradtts.py``'s tiny config with ``enc_dropout`` 0. The
JAX model runs with ``train=False`` (the prenet's dropout 0.5 is fixed in
``tpu_speech/models/text_encoder.py:59``); the port's modules run in eval
mode. Weights are the JAX package's own initialisation, carried into the port
by ``gradtts_from_jax``; JAX gradient trees go through the same function, so
gradients are compared leaf for leaf under the port's names. The JAX draws
(the crop offsets, t and z) are rebuilt from the JAX key as
``grad_tts.py:122`` and ``diffusion.py:228`` split it, and passed to the
port. Each test states its bound.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_speech.compat.torch_gradtts import convert_gradtts
from tpu_speech.data import gradtts as j_data
from tpu_speech.models import diffusion as j_diff
from tpu_speech.models.grad_tts import GradTTS as JGradTTS
from tpu_speech.models.grad_tts import synthesize as j_synthesize
from tpu_speech.ops import masks as j_masks
from tpu_speech.ops.monotonic_align import maximum_path as j_maximum_path
from tpu_speech.train.optim import clip_subtree_by_global_norm as j_clip
from tpu_speech_torch.audio.mel import mel_spectrogram_np
from tpu_speech_torch.cli import inference
from tpu_speech_torch.cli import train as train_cli
from tpu_speech_torch.cli import train_multi_speaker
from tpu_speech_torch.compat.jax_gradtts import gradtts_from_jax
from tpu_speech_torch.configs import gradtts as cfg
from tpu_speech_torch.data import gradtts as t_data
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models import diffusion as t_diff
from tpu_speech_torch.models.grad_tts import GradTTS, synthesize
from tpu_speech_torch.ops import _build
from tpu_speech_torch.ops import masks as t_masks
from tpu_speech_torch.ops.monotonic_align import MAX_NEG, maximum_path, maximum_path_plain
from tpu_speech_torch.text import symbols
from tpu_speech_torch.train.gradtts import (
    ENCODER,
    ESTIMATOR,
    GradTTSTrainer,
    batch_to_device,
    train_step,
)
from tpu_speech_torch.train import gradtts as t_train
from tpu_speech_torch.train.optim import AdamW, clip_subtree_by_global_norm
from tpu_speech_torch.utils.checkpoint import Checkpointer

TINY = dict(n_vocab=30, n_enc_channels=16, filter_channels=32, filter_channels_dp=16,
            n_heads=2, n_enc_layers=1, enc_kernel=3, enc_dropout=0.0, window_size=2,
            n_feats=8, dec_dim=8, spk_emb_dim=16)
F = TINY["n_feats"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores (a step that takes 0.5 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------- MAS


def _grid(rng, b, t_x, t_y, x_lens, y_lens, ties=False, special=False):
    value = rng.standard_normal((b, t_x, t_y)).astype(np.float32) * 4
    if ties:  # an integer grid: equal sums everywhere
        value = np.round(value / 2)
    if special:  # a NaN and a -inf inside row 0's valid cells, a -inf outside
        value[0, 2, 5], value[0, 7, 20] = np.nan, -np.inf
        value[0, -1, -1] = -np.inf  # masked: -inf * 0 is a NaN no valid cell reads
    xm = np.arange(t_x)[None, :] < np.asarray(x_lens)[:, None]
    ym = np.arange(t_y)[None, :] < np.asarray(y_lens)[:, None]
    return value, (xm[:, :, None] & ym[:, None, :]).astype(np.float32)


MAS_CASES = {
    "full": (3, 9, 20, [9, 9, 9], [20, 20, 20], False),
    "mixed_lengths": (4, 12, 40, [12, 7, 3, 10], [40, 25, 9, 31], False),
    "tx_eq_ty": (3, 16, 16, [16, 11, 5], [16, 11, 5], False),
    "ties": (4, 10, 30, [10, 10, 6, 8], [30, 17, 30, 8], True),
    "empty_rows": (3, 6, 12, [6, 0, 4], [12, 0, 0], False),
    "tx_over_ty": (2, 14, 10, [14, 9], [10, 4], False),
    # Tx not a multiple of 32, on either side of the kernel's V = 1, 2, 4 steps
    "tx31": (2, 31, 70, [31, 20], [70, 45], False),
    "tx33": (2, 33, 90, [33, 33], [90, 50], False),
    "tx65": (2, 65, 150, [65, 40], [150, 99], False),
    "nan_inf": (2, 12, 40, [12, 9], [40, 30], "special"),
}


def _case(case, seed):
    b, t_x, t_y, xl, yl, kind = MAS_CASES[case]
    return _grid(np.random.default_rng(seed), b, t_x, t_y, xl, yl, ties=kind is True,
                 special=kind == "special")


@pytest.mark.parametrize("case", sorted(MAS_CASES))
def test_maximum_path_plain_equals_jax(case):
    """Random grids with mixed lengths, rows with Tx = Ty, an integer grid
    full of ties, empty and impossible rows, Tx across multiples of 32, a
    NaN and a -inf: the paths are equal."""
    value, mask = _case(case, len(case))
    want = np.asarray(j_maximum_path(jnp.asarray(value), jnp.asarray(mask)))
    before = dict(_build.LAUNCHES)
    got = maximum_path(_t(value), _t(mask))
    assert _build.LAUNCHES == before  # the plain version on the CPU
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_width(t_x):
    """The warp path's V: cells a lane, the power of two >= ceil(Tx / 32)."""
    v = 1
    while 32 * v < t_x:
        v *= 2
    return v


def _spread(g, v):
    """The kernel's spread4 / spread2: bit t of an 8-bit (16-bit) g to bit v t."""
    steps = ((12, 0x000F000F), (6, 0x03030303), (3, 0x11111111)) if v == 4 else (
        (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555))
    for sh, mask in steps:
        g = (g | (g << sh)) & mask
    return g


def _column_words(bit, v):
    """One column's decision bits (bit[l, j]: lane l, slot j, x = l V + j) as
    the kernel stores them, V words: V = 2, 4 a ballot a slot (word j, bit
    l); else each lane's V-bit field at bit l V (a ballot at V = 1; bytes,
    halfwords, words at V = 8, 16, 32), which puts x at bit x."""
    if v in (2, 4):
        return [sum(int(bit[l, j]) << l for l in range(32)) for j in range(v)]
    fields = [sum(int(bit[l, j]) << j for j in range(v)) for l in range(32)]
    raw = b"".join(f.to_bytes(max(v, 8) // 8, "little") for f in fields)
    if v < 8:  # V = 1: the ballot's word
        raw = sum(f << l for l, f in enumerate(fields)).to_bytes(4, "little")
    return list(np.frombuffer(raw, "<u4"))


def _window(col, x0, index, layout):
    """The kernel's window<LAYOUT>: bit e is the decision at x0 + e."""
    if layout == 0:
        wl = (x0 + 32) // 32 - 1
        lo = int(col[wl]) if wl >= 0 else 0
        hi = int(col[wl + 1]) if 32 * (wl + 1) <= index else 0
        return ((hi << 32 | lo) >> (x0 - 32 * wl)) & 0xffffffff
    v, t = layout, 32 // layout
    l0 = x0 // v
    lo = hi = 0
    for j in range(v):
        w = int(col[j])
        f = (w >> l0 if l0 >= 0 else w << -l0) & 0xffffffff  # lane l0 at bit 0
        lo |= _spread(f & ((1 << t) - 1), v) << j
        hi |= ((w >> (l0 + t)) & 1 if l0 + t < 32 else 0) << j
    return ((hi << 32 | lo) >> (x0 - l0 * v)) & 0xffffffff


def _kernel_steps(value, mask, width=None, chunk=None):
    """``csrc/monotonic_align.cu``'s warp path in numpy, step for step: lane
    l's V cells x = l V + j in registers, updated from the top slot down with
    one neighbour shuffled up; each cell's decision bit (x == y or D[x, y-1] <
    D[x-1, y-1]) stored as the kernel stores it (``_column_words``); the
    backtrace 32 columns a round, each lane's 32-bit window of its column
    (``_window``) and the walk a one-hot bit over them; idx in chunks of
    ``chunk`` columns, the walk in groups of 32 aligned columns over
    reversed windows (bit k: index I - k, the one-hot d += d & u); the path
    from idx. Rows the kernel does not fill
    (x >= t_x) hold NaN here, to show that no valid cell reads them."""
    v_all = value.astype(np.float32) * mask.astype(np.float32)
    b, tx, ty = v_all.shape
    V = width or _kernel_width(tx)
    layout = V if V in (2, 4) else 0
    chunk = chunk or min((ty + 31) // 32 * 32, 2048)
    x = np.arange(32 * V).reshape(32, V)
    path = np.zeros_like(v_all)
    for i in range(b):
        t_x = min(int(mask[i, :, 0].sum()), tx)
        t_y = min(int(mask[i, 0, :].sum()), ty)
        bits = np.zeros((ty, V), np.uint64)
        d = np.full((32, V), MAX_NEG, np.float32)
        for y in range(t_y if t_x > 0 else 0):
            col = np.full(32 * V, np.nan, np.float32)
            col[:t_x] = v_all[i, :t_x, y]
            left = np.concatenate([[0.0 if y == 0 else MAX_NEG], d[:-1, V - 1]]).astype(np.float32)
            lft = np.concatenate([left[:, None], d[:, :-1]], axis=1)
            diag = x == y
            with np.errstate(invalid="ignore"):
                bit = diag | (d < lft)
                d = col.reshape(32, V) + np.maximum(np.where(diag, np.float32(MAX_NEG), d), lft)
            bits[y] = _column_words(bit, V)
        idx = np.full(ty, -1)
        index = t_x - 1
        for c0 in range((ty - 1) // chunk * chunk, -1, -chunk):
            end = max(c0, min(c0 + chunk, ty, t_y)) if t_x > 0 else c0
            for g0 in range((end - 1) // 32 * 32, c0 - 1, -32) if end > c0 else ():
                top = min(g0 + 31, end - 1)  # groups of 32 aligned columns
                x0 = index - 31
                u = [0] * 32
                for lane in range(32):
                    y = top - lane
                    if y >= g0 and y > 0:
                        u[lane] = _window(bits[y], x0, index, layout)
                        if x0 <= 0:
                            u[lane] &= ~(1 << -x0)
                # reversed windows (bit k: index - k); the one-hot moves up
                r = [int(f"{w:032b}"[::-1], 2) for w in u]
                one_hot, mine = 1, [0] * 32
                for k in range(31):
                    mine[k] = one_hot
                    one_hot += one_hot & r[k]
                mine[31] = one_hot
                for lane in range(top - g0 + 1):
                    idx[top - lane] = index - 31 + (32 - mine[lane].bit_length())
                index = index - 31 + (32 - one_hot.bit_length()) - (1 if one_hot & r[31] else 0)
        path[i] = np.arange(tx)[:, None] == idx[None, :]
    return path


@pytest.mark.parametrize("case", sorted(MAS_CASES))
def test_kernel_loops_equal_the_plain_version(case):
    """The CUDA kernel's algorithm, emulated in numpy (register slots, decision
    bits, the one-hot walk over them), gives the plain version's path and
    JAX's bit for bit (the card's check of the kernel itself is in
    test_torch_kernels_cuda.py and chip_smoke.py's phase 26)."""
    value, mask = _case(case, 7)
    got = _kernel_steps(value, mask)
    np.testing.assert_array_equal(got, maximum_path_plain(_t(value), _t(mask)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(j_maximum_path(jnp.asarray(value), jnp.asarray(mask))))


@pytest.mark.parametrize("width", [1, 2, 4, 8, 16, 32])
def test_kernel_bit_layout_at_every_width(width):
    """Every V the warp path compiles, with its layout of the decision bits
    (ballots a slot at 2 and 4, each lane's own field from 8 on) and the
    backtrace's windows over it: the emulation at a forced V equals the
    plain version on a 70-token grid and a 31-token one."""
    value, mask = _grid(np.random.default_rng(width), 2, 70, 160, [70, 51], [160, 120])
    np.testing.assert_array_equal(_kernel_steps(value, mask, width=max(width, 4)),
                                  maximum_path_plain(_t(value), _t(mask)).numpy())
    small, small_mask = _case("tx31", width)  # V = 1 and 2 need Tx <= 32 V
    np.testing.assert_array_equal(_kernel_steps(small, small_mask, width=width),
                                  maximum_path_plain(_t(small), _t(small_mask)).numpy())


def test_kernel_backtrace_in_chunks():
    """idx in chunks of 32 columns (the kernel's are 2048): the walk carries
    its index across chunks, and whole chunks past t_y hold -1."""
    value, mask = _grid(np.random.default_rng(5), 3, 40, 200, [40, 17, 30], [200, 70, 33])
    np.testing.assert_array_equal(_kernel_steps(value, mask, chunk=32),
                                  maximum_path_plain(_t(value), _t(mask)).numpy())


def test_maximum_path_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="both be"):
        maximum_path(torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))


# ---------------------------------------------------------------- losses


def test_duration_loss_and_forward_diffusion_equal_jax(rng):
    """duration_loss, forward_diffusion with the same t and z: 1e-6."""
    logw = rng.standard_normal((3, 7)).astype(np.float32)
    logw_gt = rng.standard_normal((3, 7)).astype(np.float32)
    lengths = np.array([7, 4, 1], np.int32)
    np.testing.assert_allclose(
        float(t_masks.duration_loss(_t(logw), _t(logw_gt), _t(lengths, torch.long))),
        float(j_masks.duration_loss(logw, logw_gt, lengths)), rtol=1e-6)

    x0, mu = (rng.standard_normal((3, 12, F)).astype(np.float32) for _ in range(2))
    mask = (np.arange(12)[None, :] < np.array([12, 9, 4])[:, None]).astype(np.float32)
    t = np.array([1e-5, 0.4, 1 - 1e-5], np.float32)
    key = jax.random.PRNGKey(3)
    xt_j, z_j = j_diff.forward_diffusion(x0, mask, mu, t, key, 0.05, 20.0)
    z = np.asarray(jax.random.normal(key, x0.shape))
    xt_t, z_t = t_diff.forward_diffusion(_t(x0), _t(mask)[:, :, None], _t(mu), _t(t), 0.05,
                                         20.0, z=_t(z))
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))


def test_diffusion_loss_equals_jax(rng):
    """The score-matching loss with JAX's t and z replayed and one score
    function in both: 1e-6 relative."""
    x0, mu = (rng.standard_normal((3, 16, F)).astype(np.float32) for _ in range(2))
    mask = (np.arange(16)[None, :] < np.array([16, 10, 5])[:, None]).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def score(xt, t, lib):
        return lib.tanh(xt) * t[:, None, None] - 0.5 * xt

    loss_j, xt_j = j_diff.diffusion_loss(lambda xt, t: score(xt, t, jnp), x0, mask, mu, key, F,
                                         0.05, 20.0)
    rng_t, rng_z = jax.random.split(key)
    t = np.asarray(jnp.clip(jax.random.uniform(rng_t, (3,)), 1e-5, 1 - 1e-5))
    z = np.asarray(jax.random.normal(rng_z, x0.shape))
    loss_t, xt_t = t_diff.diffusion_loss(lambda xt, t: score(xt, t, torch), _t(x0),
                                         _t(mask)[:, :, None], _t(mu), F, 0.05, 20.0,
                                         t=_t(t), z=_t(z))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt_j), rtol=0, atol=1e-6)
    # drawn from a generator when not given: t in [offset, 1 - offset], finite
    g = torch.Generator().manual_seed(0)
    loss_g, _ = t_diff.diffusion_loss(lambda xt, t: score(xt, t, torch), _t(x0),
                                      _t(mask)[:, :, None], _t(mu), F, 0.05, 20.0, generator=g)
    assert torch.isfinite(loss_g)


# ---------------------------------------------------------------- the training loss


def _with_gains(tree, rng):
    """The rezero gains init at zero: give them values so that every linear
    attention shapes the loss."""
    return {k: _with_gains(v, rng) if isinstance(v, dict) else
            (rng.uniform(0.01, 0.02, size=np.shape(v)).astype(np.float32) if k == "g"
             else np.asarray(v)) for k, v in tree.items()}


def _batch(n_spks):
    rng = np.random.default_rng(0)
    b, t_x, t_y = 3, 12, 32
    batch = {"x": rng.integers(1, TINY["n_vocab"], size=(b, t_x)).astype(np.int32),
             "x_lengths": np.array([12, 9, 5], np.int32),
             "y": rng.standard_normal((b, t_y, F)).astype(np.float32),
             "y_lengths": np.array([32, 27, 20], np.int32)}
    if n_spks > 1:
        batch["spk"] = np.array([0, 2, 1], np.int32)
    return batch


_TREES = {}


def _jax_params(n_spks):
    """JAX-initialised GradTTS params (numpy leaves), the gains drawn."""
    if n_spks not in _TREES:
        jm = JGradTTS(**dict(TINY, n_spks=n_spks))
        bt = _batch(n_spks)
        params = jax.jit(jm.init, static_argnames=("train",))(
            {"params": jax.random.PRNGKey(0)}, bt["x"], bt["x_lengths"], bt["y"],
            bt["y_lengths"], jax.random.PRNGKey(1), spk=bt.get("spk"), train=False)
        _TREES[n_spks] = _with_gains(jax.tree.map(np.asarray, params["params"]),
                                     np.random.default_rng(n_spks))
    return _TREES[n_spks]


def _port_model(n_spks, tree):
    model = GradTTS(**dict(TINY, n_spks=n_spks)).eval()
    model.load_state_dict(gradtts_from_jax(tree, TINY["n_enc_layers"], n_spks), strict=True)
    return model


_LOSSES = {}


def _jax_loss_and_grads(n_spks, out_size, seed):
    """The JAX loss's three terms and its gradient tree at PRNGKey(seed),
    computed once per case."""
    case = (n_spks, out_size, seed)
    if case not in _LOSSES:
        _LOSSES[case] = _jax_loss_and_grads_uncached(n_spks, out_size, jax.random.PRNGKey(seed))
    return _LOSSES[case]


def _jax_loss_and_grads_uncached(n_spks, out_size, key):
    jm = JGradTTS(**dict(TINY, n_spks=n_spks))
    bt = _batch(n_spks)

    def loss_fn(p):
        d, pr, df = jm.apply({"params": p}, bt["x"], bt["x_lengths"], bt["y"],
                             bt["y_lengths"], key, spk=bt.get("spk"), out_size=out_size,
                             train=False)
        return d + pr + df, (d, pr, df)

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params(n_spks))
    return [float(v) for v in losses], jax.tree.map(np.asarray, grads)


def _jax_draws(key, bt, out_size):
    """offsets, t and z as the JAX loss draws them from ``key``."""
    b, t_y = bt["y"].shape[:2]
    rng_crop, rng_diff = jax.random.split(key)
    offsets, length = None, t_y
    if out_size is not None and out_size < t_y:
        high = jnp.maximum(jnp.maximum(jnp.asarray(bt["y_lengths"]) - out_size, 0), 1)
        offsets = _t(jax.random.randint(rng_crop, (b,), 0, high), torch.long)
        length = out_size
    rng_t, rng_z = jax.random.split(rng_diff)
    t = jnp.clip(jax.random.uniform(rng_t, (b,)), 1e-5, 1 - 1e-5)
    z = jax.random.normal(rng_z, (b, length, F))
    return offsets, _t(t), _t(z)


def _port_batch(bt):
    return batch_to_device(bt, "cpu")


GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6


def _assert_grads_close(got, want):
    """Each gradient leaf within GRAD_RTOL x its max|g| or GRAD_FLOOR x the
    largest gradient anywhere, whichever is larger: the floor is about 8 fp32
    roundings of the largest, the level of the leaves whose gradient is
    exactly zero (a conv bias under GroupNorm, the key biases of attention:
    both sides hold rounding noise there, up to 1.5e-7 of the largest)."""
    assert got.keys() == want.keys()
    g_max = max(float(g.abs().max()) for g in want.values())
    for k, g_ref in want.items():
        bound = max(GRAD_RTOL * float(g_ref.abs().max()), GRAD_FLOOR * g_max)
        err = float((got[k] - g_ref).abs().max())
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("n_spks", [1, 3], ids=["spk1", "spk3"])
@pytest.mark.parametrize("out_size", [16, None], ids=["crop16of32", "nocrop"])
def test_training_loss_and_gradients_equal_jax(n_spks, out_size):
    """The three losses within 1e-5 relative and every gradient leaf within
    1e-4 x max|g|, with JAX's MAS, offsets, t and z replayed by the port's
    own search and the draws passed in."""
    key = jax.random.PRNGKey(5)
    want, grads_j = _jax_loss_and_grads(n_spks, out_size, 5)
    tree = _jax_params(n_spks)
    model = _port_model(n_spks, tree)
    bt = _batch(n_spks)
    offsets, t, z = _jax_draws(key, bt, out_size)
    b = _port_batch(bt)
    got = model(b["x"], b["x_lengths"], b["y"], b["y_lengths"], spk=b.get("spk"),
                out_size=out_size, offsets=offsets, t=t, z=z)
    sum(got).backward()
    np.testing.assert_allclose([float(v.detach()) for v in got], want, rtol=1e-5)
    want_g = gradtts_from_jax(grads_j, TINY["n_enc_layers"], n_spks)
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()}, want_g)


def test_training_forward_draws_and_crop():
    """Without draws the generator gives offsets in [0, max(y_len - out, 1)):
    the same generator seed gives the same losses; the MAS path passed as
    ``attn`` gives the losses of the search."""
    tree = _jax_params(1)
    model = _port_model(1, tree)
    b = _port_batch(_batch(1))
    args = (b["x"], b["x_lengths"], b["y"], b["y_lengths"])
    with torch.no_grad():
        runs = [model(*args, out_size=16, generator=torch.Generator().manual_seed(s))
                for s in (4, 4, 5)]
        mu_x, _, x_mask = model.encode(b["x"], b["x_lengths"])
        y_mask = t_masks.sequence_mask(b["y_lengths"], 32).float()
        attn = model.alignment(mu_x, b["y"], x_mask[:, :, None] * y_mask[:, None, :])
        replay = model(*args, out_size=16, generator=torch.Generator().manual_seed(4), attn=attn)
    assert [float(v) for v in runs[0]] == [float(v) for v in runs[1]] == [float(v) for v in replay]
    assert float(runs[0][2]) != float(runs[2][2])
    assert attn.sum(1)[0].eq(1).all()  # each frame of a full row maps to one token


def test_clip_and_adam_step_equal_jax():
    """Two steps of the per-module clip + Adam on JAX's gradients (x 50,
    clipped, then x 0.5): parameters within 2e-5 of JAX's
    clip_subtree_by_global_norm + optax.adam, both pre-clip norms within
    1e-5 relative, spk_emb's gradient unclipped."""
    n_spks = 3
    tree = _jax_params(n_spks)
    _, grads_j = _jax_loss_and_grads(n_spks, 16, 5)
    model = _port_model(n_spks, tree)
    opt = AdamW(model.parameters(), 1e-4)
    tx = optax.adam(1e-4)
    params_j, state_j = jax.tree.map(jnp.asarray, tree), tx.init(tree)
    named = list(model.named_parameters())

    @jax.jit
    def jax_step(g, state, params):
        g, enc = j_clip(g, ("encoder",), 1.0)
        g, dec = j_clip(g, ("estimator",), 1.0)
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state, enc, dec

    for scale in (50.0, 0.5):
        g_j = jax.tree.map(lambda g: jnp.asarray(g) * scale, grads_j)
        g_port = gradtts_from_jax(jax.tree.map(np.asarray, g_j), TINY["n_enc_layers"], n_spks)
        for name, p in named:
            p.grad = g_port[name].clone()
        enc_t = clip_subtree_by_global_norm(named, ENCODER, 1.0)
        dec_t = clip_subtree_by_global_norm(named, ESTIMATOR, 1.0)
        params_j, state_j, enc_j, dec_j = jax_step(g_j, state_j, params_j)
        np.testing.assert_allclose([float(enc_t), float(dec_t)], [float(enc_j), float(dec_j)],
                                   rtol=1e-5)
        if scale > 1:
            assert float(enc_t) > 1 and float(dec_t) > 1  # both clips engaged
        spk = dict(named)["spk_emb.weight"]
        assert torch.equal(spk.grad, g_port["spk_emb.weight"])  # left as it was
        opt.step()
        want = gradtts_from_jax(jax.tree.map(np.asarray, params_j), TINY["n_enc_layers"], n_spks)
        for name, p in named:
            err = float((p.detach() - want[name]).abs().max())
            assert err <= 2e-5, (name, err)


# ---------------------------------------------------------------- data


def _speech_like(rng, n, sr=22050):
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 250)
    y = sum(np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.3)) / h for h in range(1, 12))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t)) ** 2
    y = 0.2 * y * env / np.abs(y).max() + 0.002 * rng.standard_normal(n)
    return y.astype(np.float32)


WORDS = ["speech", "model", "port", "kernel", "test", "audio", "hello", "world", "quick"]


def _write_corpus(root, n, n_spks=1, seed=0, seconds=(0.5, 1.5)):
    """n 22 050 Hz wavs with random word lines; a filelist 'wav|text'
    (+ '|speaker')."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        path = os.path.join(root, f"utt{i:02d}.wav")
        write_wav(path, _speech_like(rng, int(rng.uniform(*seconds) * 22050)), 22050)
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 6))))
        lines.append(f"{path}|{text}" + (f"|{i % n_spks}" if n_spks > 1 else ""))
    filelist = os.path.join(root, "train.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


def test_mel_spectrogram_np_equals_jax(rng):
    from tpu_speech.audio.mel import mel_spectrogram_np as j_mel

    wav = _speech_like(rng, 9000)
    np.testing.assert_array_equal(mel_spectrogram_np(wav[None]), j_mel(wav[None]))


@pytest.mark.parametrize("multispeaker", [False, True], ids=["single", "speakers"])
def test_dataset_and_collate_equal_jax(tmp_path, multispeaker):
    """TextMelDataset + TextMelBatchCollate on a written corpus: the shuffled
    order, ids, speakers, padding and lengths equal, mels within 1e-6."""
    filelist = _write_corpus(str(tmp_path), 6, n_spks=3 if multispeaker else 1)
    kw = dict(n_mels=16, multispeaker=multispeaker, shuffle_seed=37)
    ds_t, ds_j = t_data.TextMelDataset(filelist, **kw), j_data.TextMelDataset(filelist, **kw)
    assert ds_t.filelist == ds_j.filelist
    items_t, items_j = [ds_t[i] for i in range(4)], [ds_j[i] for i in range(4)]
    bt = t_data.TextMelBatchCollate()(items_t)
    bj = j_data.TextMelBatchCollate()(items_j)
    assert bt.keys() == bj.keys() and ("spk" in bt) == multispeaker
    assert bt["x"].shape[1] % t_data.X_PAD_MULTIPLE == 0
    assert bt["y"].shape[1] % t_data.Y_PAD_MULTIPLE == 0
    for k in bt:
        assert bt[k].shape == bj[k].shape and bt[k].dtype == bj[k].dtype, k
        if k == "y":
            np.testing.assert_allclose(bt[k], bj[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(bt[k], bj[k])


# ---------------------------------------------------------------- checkpoints and resume


def test_checkpointer_roundtrip_and_background_save(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() is None and ckpt.restore_latest() is None
    state = {"w": torch.arange(6.0).reshape(2, 3), "count": 3, "m": {"a": torch.ones(2)}}
    ckpt.save(1, state)
    state["w"] += 1  # the save holds a copy
    ckpt.save(12, state)  # drains save(1) first
    ckpt.wait()
    assert ckpt.all_steps() == [1, 12]
    assert sorted(os.listdir(ckpt.ckpt_dir)) == ["step_0000000001.pt", "step_0000000012.pt"]
    back = ckpt.restore_latest()
    assert torch.equal(back["w"], state["w"]) and back["count"] == 3
    assert torch.equal(ckpt.restore(1)["w"], torch.arange(6.0).reshape(2, 3))


def _tiny_trainer(log_dir, seed=0, dropout=False):
    torch.manual_seed(seed)
    model = GradTTS(**TINY)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout) and not dropout:
            m.p = 0.0  # the prenet's 0.5 draws from torch's global generator
    return GradTTSTrainer(model, log_dir, learning_rate=1e-3, out_size=16, seed=9)


def _batches(n):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        bt = _batch(1)
        bt["y"] = rng.standard_normal(bt["y"].shape).astype(np.float32)
        out.append(bt)
    return out


def test_resume_equals_a_straight_run(tmp_path):
    """2 steps, a checkpoint, a new trainer that resumes and takes 1 step:
    the weights and Adam's state equal 3 straight steps exactly (each step's
    t, z and offsets come from (seed, iteration))."""
    b1, b2, b3 = _batches(3)
    first = _tiny_trainer(str(tmp_path / "a"))
    first.train_epoch([b1, b2], epoch=1)
    first.ckpt.wait()
    assert first.ckpt.all_steps() == [2]
    resumed = _tiny_trainer(str(tmp_path / "a"), seed=1)  # other initial weights
    assert resumed.resume_if_exists() and resumed.iteration == 2 and resumed.opt.count == 2
    resumed.train_epoch([b3], epoch=2)
    straight = _tiny_trainer(str(tmp_path / "b"))
    straight.train_epoch([b1, b2, b3], epoch=1)
    assert resumed.iteration == straight.iteration == 3
    for (n, p), q in zip(resumed.model.named_parameters(), straight.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(resumed.opt.state[p]["nu"], straight.opt.state[q]["nu"]), n
    with open(os.path.join(str(tmp_path / "a"), "train.log")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and lines[0].startswith("Epoch 1: duration loss = ")


def test_resume_with_dropout_equals_a_straight_run(tmp_path):
    """With the prenet's dropout on: the checkpoint keeps torch's default
    generator, so a resumed step draws the straight run's masks; a step
    after another seed would not."""
    b1, b2, b3 = _batches(3)
    first = _tiny_trainer(str(tmp_path / "a"), dropout=True)
    first.train_epoch([b1, b2], epoch=1)
    assert "rng_cpu" in first.ckpt.restore_latest()
    runs = []
    for reseed in (None, 123):
        log_dir = str(tmp_path / f"resumed_{reseed}")
        shutil.copytree(str(tmp_path / "a"), log_dir)
        resumed = _tiny_trainer(log_dir, seed=1, dropout=True)
        assert resumed.resume_if_exists() and resumed.iteration == 2
        if reseed is not None:
            torch.manual_seed(reseed)
        resumed.train_epoch([b3], epoch=2)
        runs.append(resumed)
    straight = _tiny_trainer(str(tmp_path / "b"), dropout=True)
    straight.train_epoch([b1, b2, b3], epoch=1)
    same = [all(torch.equal(p, q) for p, q in zip(r.model.parameters(),
                                                  straight.model.parameters())) for r in runs]
    assert same == [True, False]


class _Board:
    """A TensorBoard writer that records its images."""

    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step, dataformats):
        assert dataformats == "HWC" and img.dtype == np.uint8 and img.shape[2] == 3
        self.images.append(tag)


def test_trainer_logs_ground_truth_and_previews(tmp_path, monkeypatch):
    """The target mels once, and per epoch the synthesized mels and the
    alignment, to TensorBoard and as PNGs in the log dir."""
    trainer = _tiny_trainer(str(tmp_path))
    trainer.tb = _Board()
    trainer.preview_batch = {"x": np.array([[3, 4, 5, 0], [6, 7, 8, 9]], np.int32),
                             "x_lengths": np.array([3, 4], np.int32)}
    monkeypatch.setattr(t_train, "PREVIEW_TIMESTEPS", 2)
    monkeypatch.setattr(t_train, "PREVIEW_MAX_FRAMES", 32)
    trainer.log_ground_truth(_batch(1), n=2)
    trainer.log_previews(epoch=1, n=2)
    assert trainer.tb.images == [
        "image_0/ground_truth", "image_1/ground_truth",
        "image_0/generated_enc", "image_0/generated_dec", "image_0/alignment",
        "image_1/generated_enc", "image_1/generated_dec", "image_1/alignment"]
    assert {f"alignment_{i}.png" for i in range(2)} <= set(os.listdir(tmp_path))
    assert trainer.model.training  # the previews run in eval mode, then train again


def test_train_step_metrics_and_unreached_leaves():
    """The JAX package's metric keys as 0-d tensors; a leaf the loss does
    not reach gets a zero gradient (AdamW refuses None)."""
    torch.manual_seed(0)
    model = GradTTS(**TINY)
    model.register_parameter("unused", torch.nn.Parameter(torch.ones(3)))
    opt = AdamW(model.parameters(), 1e-4)
    m = train_step(model, opt, _port_batch(_batch(1)), torch.Generator().manual_seed(0), 16)
    assert sorted(m) == ["dec_grad_norm", "diff_loss", "dur_loss", "enc_grad_norm", "loss",
                         "prior_loss"]
    assert all(v.dim() == 0 and torch.isfinite(v) for v in m.values())
    assert torch.equal(model.unused.grad, torch.zeros(3))


# ---------------------------------------------------------------- the CLIs

TINY_CLI = dict(n_enc_channels=48, filter_channels=96, filter_channels_dp=64, n_enc_layers=2,
                n_feats=16, dec_dim=16, batch_size=4, n_epochs=1, out_size=32,
                cmudict_path="")


def _cli_config(monkeypatch, tmp_path, n_utts, n_spks=1, previews=False):
    root = str(tmp_path)
    filelist = _write_corpus(root, n_utts, n_spks=n_spks)
    test_list = os.path.join(root, "test.txt")
    if previews:
        with open(test_list, "w", encoding="utf-8") as f:
            f.write(f"x.wav|a short preview line|{n_spks - 1}\n")
    for k, v in dict(TINY_CLI, train_filelist_path=filelist, test_filelist_path=test_list,
                     log_dir=os.path.join(root, "logs"), n_spks=n_spks).items():
        monkeypatch.setattr(cfg, k, v)
    return os.path.join(root, "logs")


def test_train_cli_on_cpu_writes_a_model_both_clis_serve(tmp_path, monkeypatch):
    """8 utterances, 1 epoch at a tiny width on the CPU: train.log,
    config.json, a step checkpoint, previews and gradtts.pt; gradtts.pt
    serves in the port's cli/inference.py, and through the JAX package's
    convert_gradtts the JAX synthesize equals the port's within 5e-5 x
    max(1, max|JAX|) (the serving tests' bound)."""
    log_dir = _cli_config(monkeypatch, tmp_path, 8, previews=True)
    res = train_cli.main(["--device", "cpu"])
    assert res["iteration"] == 2 and res["first_epoch"] == 1 and len(res["epochs"]) == 1
    assert all(np.isfinite(v) for v in res["epochs"][0].values())
    names = set(os.listdir(log_dir))
    assert {"train.log", "config.json", "env.json", "gradtts.pt", "ckpt"} <= names
    assert {"alignment_0.png", "generated_dec_0.png"} <= names
    assert os.listdir(os.path.join(log_dir, "ckpt")) == ["step_0000000002.pt"]
    with open(os.path.join(log_dir, "train.log")) as f:
        assert len(f.read().splitlines()) == 1

    texts = str(tmp_path / "texts.txt")
    with open(texts, "w") as f:
        f.write("hello quick world\n")
    out = inference.main(["-f", texts, "-c", res["state_dict"], "--out-dir",
                          str(tmp_path / "out"), "--cmudict", "", "--device", "cpu",
                          "--hifigan", str(tmp_path / "absent.pt")])
    assert out["n_params"] == res["n_params"] and len(out["samples"]) == 1

    sd = torch.load(res["state_dict"], weights_only=True)
    params = jax.tree.map(jnp.asarray, convert_gradtts(sd, n_spks=1, n_enc_layers=2))
    kw = {k: getattr(cfg, k) for k in ("n_enc_channels", "filter_channels",
                                        "filter_channels_dp", "n_enc_layers", "n_feats",
                                        "dec_dim")}
    jm = JGradTTS(n_vocab=len(symbols) + 1, **kw)
    model = GradTTS(n_vocab=len(symbols) + 1, **kw)
    model.load_state_dict(sd)
    model.eval()
    rng = np.random.default_rng(0)
    x = rng.integers(1, len(symbols), size=(2, 11)).astype(np.int32)
    xl = np.array([11, 7], np.int32)
    key = jax.random.PRNGKey(7)
    _, dec_j, _, yl_j = j_synthesize(jm, params, jnp.asarray(x), jnp.asarray(xl), 10, 48,
                                     rng=key)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], dec_j.shape))
    with torch.no_grad():
        _, dec_t, _, yl_t = synthesize(model, _t(x, torch.long), _t(xl, torch.long), 10, 48,
                                       noise=_t(noise))
    np.testing.assert_array_equal(yl_t.numpy(), np.asarray(yl_j))
    err = np.abs(dec_t.numpy() - np.asarray(dec_j)).max()
    assert err <= 5e-5 * max(1.0, float(np.abs(np.asarray(dec_j)).max())), err


def test_train_cli_resumes_at_the_next_epoch(tmp_path, monkeypatch):
    """A second run on the same log dir with one more epoch takes exactly
    that epoch's steps."""
    _cli_config(monkeypatch, tmp_path, 4)
    assert train_cli.main(["--device", "cpu"])["iteration"] == 1
    monkeypatch.setattr(cfg, "n_epochs", 2)
    res = train_cli.main(["--device", "cpu"])
    assert res["first_epoch"] == 2 and res["iteration"] == 2 and len(res["epochs"]) == 1


def test_train_multi_speaker_cli_on_cpu(tmp_path, monkeypatch):
    log_dir = _cli_config(monkeypatch, tmp_path, 4, n_spks=3)
    res = train_multi_speaker.main(["--device", "cpu"])
    assert res["iteration"] == 1 and res["state_dict"].endswith("gradtts_multi.pt")
    sd = torch.load(res["state_dict"], weights_only=True)
    assert sd["spk_emb.weight"].shape == (3, cfg.spk_emb_dim)
    assert os.path.exists(os.path.join(log_dir, "train.log"))


def test_train_cli_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setattr(cfg, "log_dir", str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([])
    assert not os.path.exists(tmp_path / "logs")


def test_train_cli_refuses_bf16(tmp_path, monkeypatch):
    """precision = "bf16" trains on the card only: without one, the default
    device raises before a log dir is made (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setattr(cfg, "precision", "bf16")
    monkeypatch.setattr(cfg, "log_dir", str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([])
    assert not os.path.exists(tmp_path / "logs")


def test_train_cli_bf16_on_cpu_trains_float32_masters(tmp_path, monkeypatch):
    """precision = "bf16" as the JAX CLI reads it (cli/train.py:111): the
    trainer runs the mixed-precision step, the losses are finite, and the
    saved gradtts.pt holds float32 weights that moved."""
    _cli_config(monkeypatch, tmp_path, 4)
    monkeypatch.setattr(cfg, "precision", "bf16")
    seen = []
    step = t_train.train_step

    def recording(*args, **kwargs):
        seen.append(kwargs["bf16"])
        return step(*args, **kwargs)

    monkeypatch.setattr(t_train, "train_step", recording)
    init = train_cli.build_model().state_dict()
    res = train_cli.main(["--device", "cpu"])
    assert seen == [True] and res["iteration"] == 1
    assert all(np.isfinite(v) for v in res["epochs"][0].values())
    sd = torch.load(res["state_dict"], weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert any(not torch.equal(sd[k], init[k]) for k in init)


# ---------------------------------------------------------------- bf16 step


def _jax_loss_fn(jm, bt, key, out_size, bf16):
    """make_train_step's loss_fn (train/gradtts.py:38-57) with train=False
    (the prenet's fixed dropout 0.5 draws from JAX's key): the floating
    params and y cast to bf16 under bf16, the loss returned in float32."""

    def loss_fn(p):
        y = bt["y"]
        if bf16:
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                             if jnp.issubdtype(a.dtype, jnp.floating) else a, p)
            y = jnp.asarray(y).astype(jnp.bfloat16)
        d, pr, df = jm.apply({"params": p}, bt["x"], bt["x_lengths"], y, bt["y_lengths"],
                             key, spk=bt.get("spk"), out_size=out_size, train=False)
        return (d + pr + df).astype(jnp.float32), (d, pr, df)

    return loss_fn


def _jax_bf16_path(jm, tree, bt):
    """The MAS input and path of the JAX bf16 forward (grad_tts.py:104-117):
    the log-prior of the bf16 encoder's mu_x and the bf16 y, and its path."""
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    mu_x, _, x_mask = jm.apply({"params": p16}, bt["x"], bt["x_lengths"], spk=bt.get("spk"),
                               method=jm.encode)
    y = jnp.asarray(bt["y"]).astype(jnp.bfloat16)
    y_mask = j_masks.sequence_mask(jnp.asarray(bt["y_lengths"]), y.shape[1]).astype(mu_x.dtype)
    const = -0.5 * np.log(2 * np.pi) * F
    log_prior = (-0.5 * jnp.sum(y ** 2, axis=-1)[:, None, :]
                 + jnp.einsum("bxf,byf->bxy", mu_x, y)
                 + (-0.5 * jnp.sum(mu_x ** 2, axis=-1))[:, :, None] + const)
    attn_mask = x_mask[:, :, None] * y_mask[:, None, :]
    return (np.asarray(log_prior.astype(jnp.float32)),
            np.asarray(j_maximum_path(log_prior, attn_mask).astype(jnp.float32)))


def _jax_bf16_draws(key, bt, out_size):
    """offsets, t and z as the JAX bf16 loss draws them: t and z in y's
    dtype (diffusion.py:229, 42)."""
    b, t_y = bt["y"].shape[:2]
    rng_crop, rng_diff = jax.random.split(key)
    offsets, length = None, t_y
    if out_size is not None and out_size < t_y:
        high = jnp.maximum(jnp.maximum(jnp.asarray(bt["y_lengths"]) - out_size, 0), 1)
        offsets = _t(jax.random.randint(rng_crop, (b,), 0, high), torch.long)
        length = out_size
    rng_t, rng_z = jax.random.split(rng_diff)
    t = jnp.clip(jax.random.uniform(rng_t, (b,), dtype=jnp.bfloat16), 1e-5, 1 - 1e-5)
    z = jax.random.normal(rng_z, (b, length, F), dtype=jnp.bfloat16)
    return (offsets, _t(t.astype(jnp.float32)).to(torch.bfloat16),
            _t(z.astype(jnp.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("n_spks,out_size", [(1, 16), (3, None)],
                         ids=["spk1-crop16of32", "spk3-nocrop"])
def test_bf16_step_within_twice_the_jax_bf16_error(n_spks, out_size, monkeypatch):
    """train_step(bf16=True) against make_train_step(..., bf16=True)'s loss,
    with JAX's bf16 draws and MAS path passed to the port, and SGD(1) after
    the per-module clip on both sides. With L32 the JAX fp32 loss, Lj the
    JAX bf16 loss and Lp the port's: |Lp - L32| <= 2 |Lj - L32| + 5e-3
    |L32|, for the sum and each term; per gradient leaf (max|g32| at least
    1 % of the largest), after the clip: ||gp - g32|| <= 2 ||gj - g32|| +
    1e-2 ||g32|| (PR 6's rule), against the JAX fp32 step (its own fp32
    draws and path) and against the fp32 step on the bf16 draws and path.
    The port's time embedding multiplies t by pe_scale in fp32: rounding
    1000 t to bf16 (a phase error up to 1 rad) put the port 25x past the
    second yardstick, where the JAX bf16 step shows no such error. The MAS
    input is compared on its own: the
    port's bf16 log-prior within 1 % of max|JAX| (a bf16 step is 0.4 %),
    and at least 90 % of the path's cells equal. The masters, their
    gradients and the loss stay float32."""
    from tpu_speech_torch.models import grad_tts as t_grad_tts

    key = jax.random.PRNGKey(5)
    tree = _jax_params(n_spks)
    bt = _batch(n_spks)
    jm = JGradTTS(**dict(TINY, n_spks=n_spks))
    params = jax.tree.map(jnp.asarray, tree)
    runs = {}
    for bf16 in (False, True):
        (loss, terms), grads = jax.jit(jax.value_and_grad(
            _jax_loss_fn(jm, bt, key, out_size, bf16), has_aux=True))(params)
        grads, _ = j_clip(grads, ("encoder",), 1.0)
        grads, _ = j_clip(grads, ("estimator",), 1.0)
        runs[bf16] = ([float(loss)] + [float(v) for v in terms],
                      gradtts_from_jax(jax.tree.map(np.asarray, grads), TINY["n_enc_layers"],
                                       n_spks))
    prior_j, attn_j = _jax_bf16_path(jm, tree, bt)

    seen = []
    search = t_grad_tts.maximum_path

    def recording(value, mask):
        path = search(value, mask)
        seen.append((value.float(), path.float()))
        return path

    monkeypatch.setattr(t_grad_tts, "maximum_path", recording)
    model = _port_model(n_spks, tree)
    b = _port_batch(bt)
    offsets, t, z = _jax_bf16_draws(key, bt, out_size)
    draws = dict(spk=b.get("spk"), out_size=out_size, offsets=offsets, t=t, z=z)
    with torch.no_grad():  # the port's own search on the bf16 forward
        torch.func.functional_call(
            model, {n: p.to(torch.bfloat16) for n, p in model.named_parameters()},
            (b["x"], b["x_lengths"], b["y"].to(torch.bfloat16), b["y_lengths"]), draws)
    (prior_p, attn_p), = seen
    assert float((prior_p - _t(prior_j)).abs().max()) <= 1e-2 * np.abs(prior_j).max()
    assert float((attn_p == _t(attn_j)).float().mean()) >= 0.9

    m = train_step(model, torch.optim.SGD(model.parameters(), lr=1.0), b, None, out_size,
                   offsets=offsets, t=t, z=z, attn=_t(attn_j).to(torch.bfloat16), bf16=True)
    assert len(seen) == 1  # JAX's path replaced the search
    assert m["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    (l32, g32), (lj, gj) = runs[False], runs[True]
    lp = [float(m[k]) for k in ("loss", "dur_loss", "prior_loss", "diff_loss")]
    for a, want, j in zip(lp, l32, lj):
        assert abs(a - want) <= 2 * abs(j - want) + 5e-3 * abs(want), (lp, lj, l32)
    gp = {n: p.grad for n, p in model.named_parameters()}
    _assert_within_twice(gp, gj, g32)

    # the sharper yardstick: the fp32 step on the bf16 step's own draws and
    # path (the port's, which the fp32 parity test holds to JAX's), so that
    # the JAX bf16 step's distance is its rounding alone
    same = _port_model(n_spks, tree)
    train_step(same, torch.optim.SGD(same.parameters(), lr=1.0), b, None, out_size,
               offsets=offsets, t=t.float(), z=z.float(), attn=_t(attn_j), bf16=False)
    _assert_within_twice(gp, gj, {n: p.grad for n, p in same.named_parameters()})


def _assert_within_twice(gp, gj, g32):
    """Per gradient leaf with max|g32| at least 1 % of the largest:
    ||gp - g32|| <= 2 ||gj - g32|| + 1e-2 ||g32||."""
    g_max = max(float(g.abs().max()) for g in g32.values())
    for k, g in g32.items():
        if float(g.abs().max()) < 1e-2 * g_max:
            continue
        err_p, err_j = float((gp[k] - g).norm()), float((gj[k] - g).norm())
        assert err_p <= 2 * err_j + 1e-2 * float(g.norm()), (k, err_p, err_j)


def test_bf16_adam_step_keeps_float32_masters_and_moments():
    """Two bf16 steps with the port's Adam from the generator's draws: finite
    float32 losses, float32 parameters and moments, every module moved."""
    torch.manual_seed(0)
    model = GradTTS(**TINY)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AdamW(model.parameters(), 1e-3)
    for i in range(2):
        m = train_step(model, opt, _port_batch(_batch(1)), torch.Generator().manual_seed(i),
                       16, bf16=True)
        assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert opt.count == 2
    for n, p in model.named_parameters():
        assert p.dtype == opt.state[p]["mu"].dtype == opt.state[p]["nu"].dtype == torch.float32
    for part in ENCODER + ESTIMATOR:
        assert any(not torch.equal(p, init[n]) for n, p in model.named_parameters()
                   if n.startswith(part)), part
