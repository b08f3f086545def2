"""PyTorch port, DiffVC training: the port against the JAX package.

At ``tests/test_diffvc_pipeline.py``'s tiny config (8 mels, 16 channels, 2
layers, dec_dim 16). Weights are the JAX package's initialisation with the
norms' scales, every bias and the rezero gains drawn away from their initial
values, carried into the port by ``fwd_diffusion_from_jax`` and
``diffvc_from_jax``; JAX gradient trees go through the same functions, so
gradients are compared leaf for leaf under the port's names. The average
voice encoder has dropout (the prenet's fixed 0.5): the JAX encoder runs
with ``train=False`` (a subclass that pins it, so that ``make_enc_train_step``
itself runs), the port's in eval mode. The decoder's loss runs the encoder
without dropout in both packages, so the port's DiffVC runs there in train
mode, dropout set. The JAX draws (t and z, ``diffusion.py:182-185``) are
rebuilt from the step's key and passed to the port. Bounds: losses 1e-5
relative, gradients 1e-4 x max|g| (floor 1e-6 x the largest, the rounding
level of a gradient that is zero), full steps 2e-5.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io.wavfile
import torch

from tpu_speech.compat.torch_diffvc import convert_fwd_diffusion
from tpu_speech.models.diffvc import diffusion as j_diff
from tpu_speech.models.diffvc.encoder import FwdDiffusion as JFwdDiffusion
from tpu_speech.models.diffvc.vc import DiffVC as JDiffVC
from tpu_speech.train.diffvc import make_dec_train_step, make_enc_train_step
from tpu_speech.train.state import TrainState
from tpu_speech_torch.audio.mel import mel_spectrogram_np
from tpu_speech_torch.cli import get_avg_mels, inference_vc, train_dec, train_enc
from tpu_speech_torch.compat.jax_diffvc import (
    diffvc_from_jax,
    fwd_diffusion_from_jax,
    fwd_diffusion_to_jax,
)
from tpu_speech_torch.configs import diffvc as cfg
from tpu_speech_torch.models.diffvc import DiffVC, FwdDiffusion
from tpu_speech_torch.models.diffvc import diffusion as t_diff
from tpu_speech_torch.models.speaker_encoder import SpeakerEncoder
from tpu_speech_torch.train import diffvc as t_train
from tpu_speech_torch.train.diffvc import DiffVCTrainer, dec_train_step, enc_train_step
from tpu_speech_torch.train.optim import AdamW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(n_feats=8, channels=16, filters=32, heads=2, layers=2, kernel=3, dropout=0.1,
           window_size=4, dim=8)
VC = dict(n_feats=8, channels=16, filters=32, heads=2, layers=2, kernel=3, dropout=0.1,
          window_size=4, enc_dim=8, spk_dim=16, use_ref_t=True, dec_dim=16)
F = 8
BMIN, BMAX = 0.05, 20.0
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
STEP_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores (a step that takes 0.5 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_stand_in_soundfile(monkeypatch):
    """Hide a stand-in ``soundfile`` (a module with no file, as the JAX
    tests' reference oracle plants in ``sys.modules``) for the test, so the
    trainers see what is installed, not a stub without ``write``."""
    mod = sys.modules.get("soundfile")
    if mod is not None and getattr(mod, "__file__", None) is None:
        monkeypatch.delitem(sys.modules, "soundfile")


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


class _EncNoDropout(JFwdDiffusion):
    """The JAX encoder with its dropout pinned off: ``make_enc_train_step``
    applies ``train=True``."""

    def __call__(self, x, x_mask, train: bool = False):
        return super().__call__(x, x_mask, train=False)


def _away_from_init(tree, rng):
    """Rezero gains from [0.01, 0.02), norm scales and LayerNorm gammas from
    [0.5, 1.5), every bias and beta, and the kernels that init at zero (the
    prenet's residual projection), N(0, 0.05): each leaf moves the loss."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _away_from_init(v, rng)
        elif k == "g":
            out[k] = rng.uniform(0.01, 0.02, size=np.shape(v)).astype(np.float32)
        elif k in ("scale", "gamma"):
            out[k] = rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)
        elif k in ("bias", "beta") or not np.any(v):
            out[k] = (0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _enc_tree():
    x = jnp.zeros((1, 16, F))
    init = jax.jit(functools.partial(_EncNoDropout(**ENC).init, train=False))(
        jax.random.PRNGKey(0), x, jnp.ones((1, 16, 1)))
    return _away_from_init(jax.tree.map(np.asarray, init["params"]), np.random.default_rng(0))


@functools.lru_cache(maxsize=None)
def _vc_tree():
    x, xl = jnp.zeros((1, 16, F)), jnp.array([16], jnp.int32)
    init = jax.jit(functools.partial(JDiffVC(**VC).init, train=False))(
        {"params": jax.random.PRNGKey(1)}, x, xl, x, jnp.zeros((1, 256)), jax.random.PRNGKey(2))
    return _away_from_init(jax.tree.map(np.asarray, init["params"]), np.random.default_rng(1))


def _port_enc(tree=None):
    model = FwdDiffusion(**ENC).eval()
    model.load_state_dict(fwd_diffusion_from_jax(tree or _enc_tree(), ENC["layers"]))
    return model


def _port_vc(tree=None):
    model = DiffVC(**VC)
    model.load_state_dict(diffvc_from_jax(tree or _vc_tree(), VC["layers"], VC["use_ref_t"]),
                          strict=True)
    return model


def _enc_batch(lengths=(32, 25, 14), seed=0):
    r = np.random.default_rng(seed)
    b, t = len(lengths), 32
    return {"x": r.standard_normal((b, t, F)).astype(np.float32),
            "y": r.standard_normal((b, t, F)).astype(np.float32),
            "lengths": np.asarray(lengths, np.int32)}


def _dec_batch(lengths=(32, 27, 16), seed=0):
    r = np.random.default_rng(seed)
    b, t = len(lengths), 32
    c = r.standard_normal((b, 256)).astype(np.float32)
    return {"mel1": r.standard_normal((b, t, F)).astype(np.float32),
            "mel2": r.standard_normal((b, t, F)).astype(np.float32),
            "mel_lengths": np.asarray(lengths, np.int32),
            "c": c / np.linalg.norm(c, axis=1, keepdims=True)}


def _port_batch(bt):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in bt.items()}


def _jax_draws(key, shape):
    """t and z as the JAX decoder loss draws them from ``key``."""
    rng_t, rng_z = jax.random.split(key)
    t = jnp.clip(jax.random.uniform(rng_t, (shape[0],)), 1e-5, 1 - 1e-5)
    return _t(t), _t(jax.random.normal(rng_z, shape))


def _assert_grads_close(got, want):
    """Each leaf within GRAD_RTOL x its max|g|, or GRAD_FLOOR x the largest
    gradient anywhere where that is larger (a bias under a norm: rounding
    noise on both sides)."""
    assert got.keys() == want.keys()
    g_max = max(float(g.abs().max()) for g in want.values())
    for k, g_ref in want.items():
        bound = max(GRAD_RTOL * float(g_ref.abs().max()), GRAD_FLOOR * g_max)
        err = float((got[k] - g_ref).abs().max())
        assert err <= bound, (k, err, bound)


# ---------------------------------------------------------------- the diffusion algebra


def test_forward_diffusion_equals_jax(rng):
    """x_t and z with JAX's z replayed: 1e-5 (z exactly, masked)."""
    x0, mean = (rng.standard_normal((3, 12, F)).astype(np.float32) for _ in range(2))
    mask = (np.arange(12)[None, :] < np.array([12, 7, 3])[:, None]).astype(np.float32)
    t = np.array([1e-5, 0.37, 1 - 1e-5], np.float32)
    key = jax.random.PRNGKey(4)
    xt_j, z_j = j_diff.forward_diffusion(x0, mask, mean, t, key, BMIN, BMAX)
    z = _t(jax.random.normal(key, x0.shape))
    xt_t, z_t = t_diff.forward_diffusion(_t(x0), _t(mask)[:, :, None], _t(mean), _t(t), BMIN,
                                         BMAX, z=z)
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt_j), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))


def test_diffusion_loss_equals_jax(rng):
    """The score-matching loss with JAX's t and z replayed and one score
    function in both (which reads the diffused reference, diffused under
    the source's mask): 1e-5 relative; without draws it draws from its
    generator, the same seed giving the same loss."""
    x0, mean, ref, mean_ref = (rng.standard_normal((3, 16, F)).astype(np.float32)
                               for _ in range(4))
    mask = (np.arange(16)[None, :] < np.array([16, 10, 5])[:, None]).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def score(xt, xt_ref, t, lib):
        return lib.tanh(xt) * t[:, None, None] - 0.5 * xt + 0.3 * xt_ref

    want = j_diff.diffusion_loss(lambda *a: score(*a, jnp), x0, mask, mean, ref, mean_ref, key,
                                 F, BMIN, BMAX)
    t, z = _jax_draws(key, x0.shape)
    args = (lambda *a: score(*a, torch), _t(x0), _t(mask)[:, :, None], _t(mean), _t(ref),
            _t(mean_ref), F, BMIN, BMAX)
    got = t_diff.diffusion_loss(*args, t=t, z=z)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    drawn = [float(t_diff.diffusion_loss(*args, generator=torch.Generator().manual_seed(s)))
             for s in (3, 3, 4)]
    assert drawn[0] == drawn[1] != drawn[2] and np.isfinite(drawn).all()


# ---------------------------------------------------------------- the losses and gradients


@pytest.mark.parametrize("lengths", [(32, 32, 32), (32, 25, 14)], ids=["full", "mixed"])
def test_encoder_loss_and_gradients_equal_jax(lengths):
    """FwdDiffusion.compute_loss (the masked MSE over sum(mask) x n_feats):
    the loss 1e-5 relative, every gradient 1e-4 x its max|g|."""
    tree, bt = _enc_tree(), _enc_batch(lengths)
    jm = _EncNoDropout(**ENC)
    mask = (np.arange(32)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[:, :, None]

    def loss_fn(p):
        return jm.apply({"params": p}, bt["x"], bt["y"], mask,
                        method=JFwdDiffusion.compute_loss)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    model = _port_enc(tree)
    got = model.compute_loss(_t(bt["x"]).transpose(1, 2), _t(bt["y"]).transpose(1, 2),
                             _t(mask).transpose(1, 2))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                        fwd_diffusion_from_jax(jax.tree.map(np.asarray, grads), ENC["layers"]))


def test_decoder_loss_and_gradients_equal_jax():
    """DiffVC.forward, the port's module in train mode (dropout 0.1 and the
    prenet's 0.5 set), JAX's t and z replayed, one full row and two
    padded: the loss 1e-5 relative, the estimator's gradients 1e-4 x
    max|g|; no gradient reaches the encoder (JAX's is zero by its
    stop_gradient)."""
    bt = _dec_batch()
    jm = JDiffVC(**VC)

    def loss_fn(p):
        return jm.apply({"params": p}, bt["mel1"], bt["mel_lengths"], bt["mel2"], bt["c"],
                        jax.random.PRNGKey(5))

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(_vc_tree())
    want, grads = float(want), jax.tree.map(np.asarray, grads)
    model = _port_vc().train()
    b = _port_batch(bt)
    t, z = _jax_draws(jax.random.PRNGKey(5), b["mel1"].shape)
    loss = model(b["mel1"], b["mel_lengths"], b["mel2"], b["c"], t=t, z=z)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    want_g = diffvc_from_jax(grads, VC["layers"], VC["use_ref_t"])
    assert all(float(want_g[n].abs().max()) == 0 for n in want_g if n.startswith("encoder."))
    named = dict(model.named_parameters())
    assert all(named[n].grad is None for n in named if n.startswith("encoder."))
    _assert_grads_close({n: p.grad for n, p in named.items() if not n.startswith("encoder.")},
                        {n: g for n, g in want_g.items() if not n.startswith("encoder.")})


def test_encoder_stays_eval_inside_a_training_module():
    """In train mode the decoder's loss runs the encoder with its dropout
    off: two other dropout seeds give the eval module's loss bit for bit,
    and the encoder is back in train mode after. With the prenet's dropout
    left on (the encoder called as the module's mode has it) the losses
    move: this test's own check that it can see the fault."""
    model = _port_vc()
    b = _port_batch(_dec_batch())
    t, z = _jax_draws(jax.random.PRNGKey(5), b["mel1"].shape)
    args = (b["mel1"], b["mel_lengths"], b["mel2"], b["c"])
    with torch.no_grad():
        ref = float(model.eval()(*args, t=t, z=z))
        model.train()
        runs = []
        for seed in (0, 1):
            torch.manual_seed(seed)
            runs.append(float(model(*args, t=t, z=z)))
        assert model.encoder.training and model.encoder.encoder.prenet.training
        assert runs == [ref, ref]

        def unfrozen(module):  # the fault: the encoder runs in the module's mode
            import contextlib

            return contextlib.nullcontext()

        from tpu_speech_torch.models.diffvc import vc as vc_mod

        saved, vc_mod.frozen = vc_mod.frozen, unfrozen
        try:
            torch.manual_seed(0)
            faulty = float(model(*args, t=t, z=z))
        finally:
            vc_mod.frozen = saved
    assert abs(faulty - ref) > 1e-3 * abs(ref)


# ---------------------------------------------------------------- the full steps


@pytest.fixture(scope="module")
def jax_steps():
    """One jitted JAX step per stage: ``make_enc_train_step`` (Adam 5e-4)
    and ``make_dec_train_step`` (Adam 1e-4)."""
    return {"enc": (make_enc_train_step(_EncNoDropout(**ENC), optax.adam(5e-4)),
                    optax.adam(5e-4)),
            "dec": (make_dec_train_step(JDiffVC(**VC), optax.adam(1e-4)), optax.adam(1e-4))}


def _assert_step_close(model, want, lr, steps):
    """The parameters after ``steps`` steps within STEP_ATOL of JAX's. Where
    a gradient is rounding noise (max|g| at most GRAD_FLOOR x the largest: a
    conv bias under GroupNorm, the attention's key bias, whose gradients are
    zero but for rounding) each Adam step, about lr g / (|g| + eps), is
    anything in [-lr, lr] on either side, so those leaves are held to 2 lr a
    step. A gradient of exactly zero (the frozen encoder's) moves nothing."""
    g_max = max(float(p.grad.abs().max()) for p in model.parameters())
    noise = []
    for n, p in model.named_parameters():
        err = float((p.detach() - want[n]).abs().max())
        if 0 < float(p.grad.abs().max()) <= GRAD_FLOOR * g_max:
            noise.append(n)
            assert err <= 2 * lr * steps, (n, err)
        else:
            assert err <= STEP_ATOL, (n, err)
    assert all(n.endswith(".bias") for n in noise), noise


def test_enc_train_step_equals_jax(jax_steps):
    """Two steps of the loss, the global clip to 1 (engaged: the norms are
    above 1) and Adam 5e-4: the loss and the pre-clip norm within 1e-5
    relative, the parameters within 2e-5 (see ``_assert_step_close``)."""
    step, tx = jax_steps["enc"]
    tree = _enc_tree()
    state = TrainState.create({"params": jax.tree.map(jnp.asarray, tree)}, tx)
    model = _port_enc(tree)
    opt = AdamW(model.parameters(), 5e-4)
    for i in range(2):
        bt = _enc_batch(seed=i)
        state, m_j = step(state, bt, jax.random.PRNGKey(i))
        m_t = enc_train_step(model, opt, _port_batch(bt))
        np.testing.assert_allclose([float(m_t["loss"]), float(m_t["grad_norm"])],
                                   [float(m_j["loss"]), float(m_j["grad_norm"])], rtol=1e-5)
        assert float(m_t["grad_norm"]) > 1.0  # the clip engaged
        want = fwd_diffusion_from_jax(jax.tree.map(np.asarray, state.params["params"]),
                                      ENC["layers"])
        _assert_step_close(model, want, 5e-4, i + 1)


def test_dec_train_step_equals_jax_and_freezes_the_encoder(jax_steps):
    """Two steps with JAX's draws replayed: the loss and the estimator's
    pre-clip norm within 1e-5 relative, the parameters within 2e-5 of
    make_dec_train_step's (``_assert_step_close``), the encoder bit for bit
    unchanged (zero
    gradients and zero moments: Adam moves it by exactly 0)."""
    step, tx = jax_steps["dec"]
    tree = _vc_tree()
    state = TrainState.create({"params": jax.tree.map(jnp.asarray, tree)}, tx)
    model = _port_vc().train()
    enc_before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    opt = AdamW(model.parameters(), 1e-4)
    for i in range(2):
        bt = _dec_batch(seed=i)
        key = jax.random.PRNGKey(10 + i)
        state, m_j = step(state, bt, key)
        b = _port_batch(bt)
        t, z = _jax_draws(key, b["mel1"].shape)
        m_t = dec_train_step(model, opt, b, t=t, z=z)
        np.testing.assert_allclose([float(m_t["loss"]), float(m_t["grad_norm"])],
                                   [float(m_j["loss"]), float(m_j["grad_norm"])], rtol=1e-5)
        want = diffvc_from_jax(jax.tree.map(np.asarray, state.params["params"]), VC["layers"])
        _assert_step_close(model, want, 1e-4, i + 1)
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, enc_before[k]), k


def test_steps_draw_from_their_generator_and_zero_unreached_leaves():
    """Without draws the decoder step draws t and z from its generator (the
    same seed, the same loss); the metrics are 0-d tensors; a leaf the loss
    does not reach gets a zero gradient."""
    losses = []
    for seed in (7, 7, 8):
        model = _port_vc().train()
        model.register_parameter("unused", torch.nn.Parameter(torch.ones(2)))
        m = dec_train_step(model, AdamW(model.parameters(), 1e-4), _port_batch(_dec_batch()),
                           torch.Generator().manual_seed(seed))
        assert sorted(m) == ["grad_norm", "loss"] and all(v.dim() == 0 for v in m.values())
        assert torch.equal(model.unused.grad, torch.zeros(2))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------- the trainer and resume


def _tiny_trainer(stage, log_dir, seed=0):
    torch.manual_seed(seed)  # the initial weights, and dropout's generator
    if stage == "enc":
        return DiffVCTrainer(FwdDiffusion(**ENC), enc_train_step, log_dir, 1e-3, seed=9)
    model = DiffVC(**VC)
    return DiffVCTrainer(model, dec_train_step, log_dir, 1e-3, seed=9)


def _stage_batches(stage):
    return [(_enc_batch if stage == "enc" else _dec_batch)(seed=s) for s in range(3)]


@pytest.mark.parametrize("stage", ["enc", "dec"])
def test_resume_equals_a_straight_run(tmp_path, stage):
    """2 steps, a checkpoint, a new trainer (other initial weights, another
    dropout seed) that resumes and takes 1 step: the weights and Adam's
    moments equal 3 straight steps exactly. The encoder's dropout is on (the
    checkpoint keeps torch's generator); the decoder's t and z come from
    (seed, iteration)."""
    b1, b2, b3 = _stage_batches(stage)
    first = _tiny_trainer(stage, str(tmp_path / "a"))
    first.train_epoch([b1, b2], epoch=1)
    first.ckpt.wait()
    resumed = _tiny_trainer(stage, str(tmp_path / "a"), seed=1)
    assert resumed.resume_if_exists() and resumed.iteration == 2 and resumed.opt.count == 2
    resumed.train_epoch([b3], epoch=2)
    straight = _tiny_trainer(stage, str(tmp_path / "b"))
    straight.train_epoch([b1, b2, b3], epoch=1)
    for (n, p), q in zip(resumed.model.named_parameters(), straight.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(resumed.opt.state[p]["nu"], straight.opt.state[q]["nu"]), n
    with open(os.path.join(str(tmp_path / "a"), "train.log")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and lines[0].startswith("Epoch 1: loss = ")
    assert [len(h) for h in straight.history] == [2, 2, 2]


# ---------------------------------------------------------------- the CLIs

TINY_CLI = dict(channels=32, filters=64, layers=2, enc_dim=16, spk_dim=32, dec_dim=16,
                train_frames=32)
PHONES = ["AH0", "S", "IY1", "N", "T", "sil"]


def _speech(rng, n, f0):
    t = np.arange(n) / 22050
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h for h in range(1, 8))
    y *= 0.5 * (1 + np.sin(2 * np.pi * 3 * t)) ** 2
    return (0.2 * y / np.abs(y).max() + 0.002 * rng.standard_normal(n)).astype(np.float32)


def _textgrid(intervals, xmax):
    items = "".join(
        f'        intervals [{i + 1}]:\n            xmin = {a}\n            xmax = {b}\n'
        f'            text = "{text}"\n' for i, (a, b, text) in enumerate(intervals))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
            f'xmax = {xmax}\ntiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n'
            '        class = "IntervalTier"\n        name = "phones"\n        xmin = 0\n'
            f'        xmax = {xmax}\n        intervals: size = {len(intervals)}\n{items}')


def write_vc_corpus(root, n_speakers=2, n_utts=10, seed=0):
    """A DiffVC data dir: per speaker ``n_utts`` speech-like 22 050 Hz
    utterances of 0.45-0.7 s as host mels (``mel_spectrogram_np``, (80, T)),
    unit speaker embeddings and TextGrids of phone intervals. Returns the
    source and target wavs of one utterance each."""
    rng = np.random.default_rng(seed)
    wavs = []
    for s in range(n_speakers):
        spk = f"spk{s}"
        for d in ("mels", "embeds", "textgrids"):
            os.makedirs(os.path.join(root, d, spk), exist_ok=True)
        c = rng.standard_normal(256).astype(np.float32)
        for u in range(n_utts):
            uid = f"{spk}_{u:03d}"
            wav = _speech(rng, int(rng.uniform(0.45, 0.7) * 22050), 120 + 60 * s)
            wav = wav[: len(wav) // 256 * 256]
            mel = mel_spectrogram_np(wav[None])[0]  # (T, 80)
            np.save(os.path.join(root, "mels", spk, f"{uid}_mel.npy"), mel.T)
            e = c + 0.1 * rng.standard_normal(256).astype(np.float32)
            np.save(os.path.join(root, "embeds", spk, f"{uid}_embed.npy"), e / np.linalg.norm(e))
            secs = len(wav) / 22050
            cuts = np.sort(rng.uniform(0, secs, 5))
            edges = [0.0, *cuts, secs]
            tg = _textgrid([(round(a, 4), round(b, 4), PHONES[i % len(PHONES)])
                            for i, (a, b) in enumerate(zip(edges[:-1], edges[1:]))], secs)
            with open(os.path.join(root, "textgrids", spk, f"{uid}.TextGrid"), "w") as f:
                f.write(tg)
            if u == 0:
                path = os.path.join(root, f"{spk}.wav")
                scipy.io.wavfile.write(path, 22050, (wav * 32767).astype(np.int16))
                wavs.append(path)
    return wavs


@pytest.fixture
def tiny_cli(monkeypatch):
    for k, v in TINY_CLI.items():
        monkeypatch.setattr(cfg, k, v)


def test_clis_on_cpu_train_and_convert(tmp_path, tiny_cli, monkeypatch):
    """20 utterances of 2 speakers at a tiny width (80 mels): get_avg_mels
    paints the targets; train_enc for 1 epoch (2 steps), then a second run
    on its log dir with 2 epochs that resumes at epoch 2; train_dec from its
    enc.pt for 1 epoch with the encoder bit for bit unchanged; the previews'
    wavs and images; cli.inference_vc on the trained diffvc.pt and a
    {'model_state': ...} speaker encoder: a finite converted mel."""
    monkeypatch.setattr(t_train, "PREVIEW_TIMESTEPS", 2)
    root = str(tmp_path / "data")
    src, tgt = write_vc_corpus(root)
    modes = get_avg_mels.main(["--data-dir", root])
    assert set(modes) == set(PHONES) and all(v.shape == (80,) for v in modes.values())
    assert len(os.listdir(os.path.join(root, "mels_mode", "spk0"))) == 10
    enc_dir = str(tmp_path / "enc")
    common = ["--data-dir", root, "--device", "cpu", "--batch-size", "8"]
    r1 = train_enc.main(common + ["--log-dir", enc_dir, "--epochs", "1"])
    assert r1["iteration"] == 2 and r1["first_epoch"] == 1 and np.isfinite(r1["losses"]).all()
    r2 = train_enc.main(common + ["--log-dir", enc_dir, "--epochs", "2"])
    assert r2["first_epoch"] == 2 and r2["iteration"] == 4 and len(r2["losses"]) == 1
    names = set(os.listdir(enc_dir))
    assert {"train.log", "config.json", "enc.pt", "ckpt", "enc_0_predicted_avg.wav",
            "enc_1_target_avg.png"} <= names
    enc_sd = torch.load(r2["state_dict"], weights_only=True)
    FwdDiffusion(80, 32, 64, 2, 2, 3, 0.1, 4, 16).load_state_dict(enc_sd, strict=True)

    dec_dir = str(tmp_path / "dec")
    r3 = train_dec.main(common + ["--log-dir", dec_dir, "--epochs", "1", "--enc-ckpt",
                                  r2["state_dict"]])
    assert r3["iteration"] == 2 and np.isfinite(r3["losses"]).all()
    assert {"diffvc.pt", "dec_0_generated.wav", "dec_1_source.png"} <= set(os.listdir(dec_dir))
    sd = torch.load(r3["state_dict"], weights_only=True)
    for k, v in enc_sd.items():
        assert torch.equal(sd[f"encoder.{k}"], v), k

    spk = SpeakerEncoder().init_weights(torch.Generator().manual_seed(1))
    spk_pt = str(tmp_path / "spk.pt")
    torch.save({"model_state": spk.state_dict(), "step": 1}, spk_pt)
    out = inference_vc.main(["-s", src, "-t", tgt, "-c", r3["state_dict"], "--spk-encoder",
                             spk_pt, "-n", "2", "--device", "cpu",
                             "-o", str(tmp_path / "out.wav")])
    assert out["finite"]["mel"] and out["samples"] == (out["frames"] - 1) * 256


def test_clis_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cli, extra in ((train_enc, []), (train_dec, ["--enc-ckpt", "enc.pt"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--data-dir", str(tmp_path), "--log-dir", str(tmp_path / "l")] + extra)
    assert not os.path.exists(tmp_path / "l")


def test_clis_refuse_bf16_and_orbax(tmp_path):
    """Orbax stays refused (an --enc-ckpt directory); --precision bf16 is
    ported (``tests/test_torch_diffvc_bf16.py`` trains with it), so both
    CLIs parse it and neither refuses it any more."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_dec.load_encoder_params(str(tmp_path))
    for cli, extra in ((train_enc, []), (train_dec, ["--enc-ckpt", "enc.pt"])):
        args = cli.build_parser().parse_args(
            ["--data-dir", str(tmp_path), "--precision", "bf16"] + extra)
        assert args.precision == "bf16"
        assert not hasattr(cli, "refuse_bf16")


# ---------------------------------------------------------------- checkpoints across packages


def test_encoder_converters_go_both_ways_exactly(tmp_path):
    """The encoder's state_dict -> fwd_diffusion_to_jax equals the JAX
    package's convert_fwd_diffusion leaf for leaf, and both directions
    return their input bit for bit; an .npz of the JAX tree loads through
    the port's load_encoder_params; the converters are strict."""
    model = _port_enc()
    sd = model.state_dict()
    tree = fwd_diffusion_to_jax(sd, ENC["layers"])
    theirs = convert_fwd_diffusion(sd, "", ENC["layers"])
    assert jax.tree.structure(tree) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)
    back = fwd_diffusion_from_jax(tree, ENC["layers"])
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    again = fwd_diffusion_to_jax(back, ENC["layers"])
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(_enc_tree())):
        np.testing.assert_array_equal(a, b)
    flat = {"params/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    npz = str(tmp_path / "enc.npz")
    np.savez(npz, **flat)
    cfg_layers = cfg.layers
    try:
        cfg.layers = ENC["layers"]
        loaded = train_dec.load_encoder_params(npz)
    finally:
        cfg.layers = cfg_layers
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="unconsumed torch keys"):
        fwd_diffusion_to_jax(dict(sd, stray=torch.zeros(1)), ENC["layers"])
    tree["postnet"]["stray"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        fwd_diffusion_from_jax(tree, ENC["layers"])


def test_jax_cli_loads_the_ports_stage_one_checkpoint(tmp_path, monkeypatch):
    """The JAX package's cli/train_dec.py::load_encoder_params reads the
    .pt that the port's trainer writes (``save_state_dict('enc')``) into
    the tree the port's weights came from, exactly."""
    trainer = DiffVCTrainer(_port_enc(), enc_train_step, str(tmp_path), 1e-4)
    path = trainer.save_state_dict("enc")
    monkeypatch.syspath_prepend(os.path.join(REPO, "cli"))
    spec = importlib.util.spec_from_file_location("jax_cli_train_dec",
                                                  os.path.join(REPO, "cli", "train_dec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.params, "layers", ENC["layers"])
    tree = mod.load_encoder_params(path)
    want = _enc_tree()
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_preview_writes_wavs_without_images(tmp_path):
    """With images off (the card machine has no matplotlib) the previews
    still write each item's Griffin-Lim wav."""
    trainer = DiffVCTrainer(FwdDiffusion(80, 16, 32, 2, 1, 3, 0.1, 4, 8), enc_train_step,
                            str(tmp_path), 1e-4)
    r = np.random.default_rng(0)
    batch = {"x": r.standard_normal((2, 16, 80)).astype(np.float32) - 4,
             "y": r.standard_normal((2, 16, 80)).astype(np.float32) - 4,
             "lengths": np.array([16, 12], np.int32)}
    t_train.make_enc_preview(batch, images=False)(trainer, 1)
    got = sorted(os.listdir(tmp_path))
    assert [n for n in got if n.endswith(".png")] == []
    assert "enc_1_predicted_avg.wav" in got and trainer.model.training
