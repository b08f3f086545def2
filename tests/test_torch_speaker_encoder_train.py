"""PyTorch port, GE2E speaker-encoder training: the port against the JAX
package.

At a tiny LSTM (hidden 16, embedding 16, 2 layers) and 4 speakers x 3
utterances x 20 frames of 40 mels, with the JAX package's initialisation
(biases drawn away from zero) carried into the port by ``ge2e_from_jax``.
Bounds: the similarity 1e-6 x max(1, max|sim|), the loss 1e-5 relative,
the EER equal; one step's gradients after the 0.01 scale and the norm-3
clip 1e-4 x max|g|, its parameters 2e-5; the sampler's batches equal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_speech.compat.torch_speaker_encoder import convert_speaker_encoder
from tpu_speech.data.speaker_verification import SpeakerVerificationSampler as JSampler
from tpu_speech.models import speaker_encoder as j_spk
from tpu_speech.train.speaker_encoder import GE2EState, init_ge2e_state, make_ge2e_train_step
from tpu_speech_torch.cli import inference_vc, preprocess_spk, train_spk_encoder
from tpu_speech_torch.compat.jax_diffvc import ge2e_from_jax, ge2e_to_jax
from tpu_speech_torch.data.speaker_verification import SpeakerVerificationSampler
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models import speaker_encoder as t_spk
from tpu_speech_torch.train.optim import AdamW
from tpu_speech_torch.train.speaker_encoder import ge2e_train_step, train_speaker_encoder

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the LSTMs' ops are small, and under
    the suite's six workers a team of threads per op spins on shared cores
    (a loop that takes 0.6 s alone took minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(hidden_size=16, embedding_size=16, num_layers=2)
S, U, T = 4, 3, 20


def _t(a):
    return torch.tensor(np.asarray(a))


def _embeds(rng, s=S, u=U, e=16):
    x = rng.standard_normal((s, u, e)).astype(np.float32) + 2 * rng.standard_normal(
        (s, 1, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=2, keepdims=True)


def test_similarity_and_loss_equal_jax(rng):
    """similarity_matrix within 1e-6 x max(1, max|sim|) (the scale w makes
    the entries up to w + |b|: float32 spacing there is 4.8e-7), ge2e_loss
    1e-5 relative, at the reference's initial scalars and at others."""
    emb = _embeds(rng)
    for w, b in ((10.0, -5.0), (3.5, 0.25)):
        sim_j = np.asarray(j_spk.similarity_matrix(jnp.asarray(emb), w, b))
        sim_t = t_spk.similarity_matrix(_t(emb), torch.tensor([w]), torch.tensor([b]))
        atol = 1e-6 * max(1.0, float(np.abs(sim_j).max()))
        np.testing.assert_allclose(sim_t.numpy(), sim_j, rtol=0, atol=atol)
        loss_j, flat_j = j_spk.ge2e_loss(jnp.asarray(emb), w, b)
        loss_t, flat_t = t_spk.ge2e_loss(_t(emb), torch.tensor([w]), torch.tensor([b]))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        assert flat_t.shape == (S * U, S)
        np.testing.assert_allclose(flat_t.numpy(), np.asarray(flat_j), rtol=0, atol=atol)


@pytest.mark.parametrize("n_speakers", [4, 7])
def test_equal_error_rate_equals_jax(n_speakers):
    r = np.random.default_rng(n_speakers)
    for scale in (0.3, 1.0, 5.0):
        sim = (r.standard_normal((n_speakers * 3, n_speakers)) + scale * np.repeat(
            np.eye(n_speakers), 3, axis=0)).astype(np.float32)
        assert t_spk.equal_error_rate(sim, n_speakers) == j_spk.equal_error_rate(sim, n_speakers)


@functools.lru_cache(maxsize=None)
def _jax_state_tree():
    """The JAX GE2E state's parameters, the LSTM and linear biases drawn
    N(0, 0.1) (they init at zero)."""
    state = init_ge2e_state(j_spk.SpeakerEncoder(**TINY), jax.random.PRNGKey(0), T, 40,
                            optax.adam(1e-4))
    r = np.random.default_rng(0)
    model = jax.tree_util.tree_map_with_path(
        lambda path, v: (0.1 * r.standard_normal(v.shape)).astype(np.float32)
        if "b_" in path[-1].key or path[-1].key == "bias" else np.asarray(v), state.params)
    return {"model": model, "sim_weight": np.float32(10.0), "sim_bias": np.float32(-5.0)}


def _frames(scale, seed=0):
    """Each speaker's frames around a mean of its own, times ``scale``."""
    r = np.random.default_rng(seed)
    mean = r.standard_normal((S, 1, 1, 40)).astype(np.float32)
    return ((mean + 0.5 * r.standard_normal((S, U, T, 40))) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX step, make_ge2e_train_step with Adam 1e-3."""
    return make_ge2e_train_step(j_spk.SpeakerEncoder(**TINY), optax.adam(1e-3))


def _jax_clipped_grads(tree, frames):
    """The gradients the JAX step applies: the loss's, the similarity pair's
    x 0.01, all clipped to norm 3 (``make_ge2e_train_step:50-60``)."""
    model = j_spk.SpeakerEncoder(**TINY)

    def loss_fn(p, w, b):
        e = model.apply({"params": p}, jnp.asarray(frames).reshape(S * U, T, 40))
        return j_spk.ge2e_loss(e.reshape(S, U, -1), w, b)[0]

    g_m, g_w, g_b = jax.grad(loss_fn, argnums=(0, 1, 2))(tree["model"], tree["sim_weight"],
                                                          tree["sim_bias"])
    full = {"model": g_m, "sim_weight": g_w * 0.01, "sim_bias": g_b * 0.01}
    norm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree.leaves(full))))
    scale = min(1.0, 3.0 / (norm + 1e-6))
    return jax.tree.map(lambda g: np.asarray(g) * np.float32(scale), full), norm


@pytest.mark.parametrize("scale", [0.1, 1.0], ids=["unclipped", "clipped"])
def test_ge2e_train_step_equals_jax(jax_step, scale):
    """One step: the loss and the pre-clip norm 1e-5 relative, the
    gradients after the 0.01 scale and the clip 1e-4 x max|g|, the
    parameters after Adam 2e-5 (the similarity bias, whose gradient is
    rounding noise, within Adam's step). Louder frames push the norm past
    3, where the clip engages."""
    tree = _jax_state_tree()
    frames = _frames(scale)
    state = GE2EState(jnp.zeros((), jnp.int32), tree["model"], jnp.asarray(tree["sim_weight"]),
                      jnp.asarray(tree["sim_bias"]), optax.adam(1e-3).init(
                          {"model": tree["model"], "sim_weight": tree["sim_weight"],
                           "sim_bias": tree["sim_bias"]}))
    want_g, norm = _jax_clipped_grads(tree, frames)
    assert (norm > 3.0) == (scale > 0.5)
    state, m_j = jax_step(state, jnp.asarray(frames))

    model = t_spk.SpeakerEncoder(**TINY).train()
    model.load_state_dict(ge2e_from_jax(tree, TINY["num_layers"]))
    opt = AdamW(model.parameters(), 1e-3)
    m_t = ge2e_train_step(model, opt, _t(frames))
    np.testing.assert_allclose([float(m_t["loss"]), float(m_t["grad_norm"])],
                               [float(m_j["loss"]), float(m_j["grad_norm"])], rtol=1e-5)
    np.testing.assert_allclose(m_t["sim"].numpy(), np.asarray(m_j["sim"]), rtol=0, atol=1e-5)
    assert m_t["embeds"].shape == (S, U, 16)
    want = ge2e_from_jax(want_g, TINY["num_layers"])
    g_max = max(float(g.abs().max()) for g in want.values())
    after = ge2e_from_jax({"model": jax.tree.map(np.asarray, state.params),
                           "sim_weight": np.asarray(state.sim_weight),
                           "sim_bias": np.asarray(state.sim_bias)}, TINY["num_layers"])
    for n, p in model.named_parameters():
        err = float((p.grad - want[n]).abs().max())
        moved = float((p.detach() - after[n]).abs().max())
        if float(want[n].abs().max()) > 1e-6 * g_max:
            assert err <= 1e-4 * float(want[n].abs().max()), (n, err)
            assert moved <= 2e-5, (n, moved)
        else:
            # the bias's gradient is zero but for rounding (the softmax is
            # shift-invariant): both sides' Adam steps are anything in
            # [-lr, lr]
            assert n == "similarity_bias" and err <= 1e-6 * g_max and moved <= 2e-3, (n, err)


def test_ge2e_converters_go_both_ways_exactly():
    """The GE2E parameters to the port and back bit for bit, the scalars 0-d
    in JAX and [1] in the port; the JAX package's convert_speaker_encoder
    reads the port's state_dict into the same model tree; strict both ways."""
    tree = _jax_state_tree()
    sd = ge2e_from_jax(tree, TINY["num_layers"])
    assert sd["similarity_weight"].shape == (1,) and float(sd["similarity_bias"]) == -5.0
    back = ge2e_to_jax(sd, TINY["num_layers"])
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert np.shape(back["sim_weight"]) == ()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    theirs = convert_speaker_encoder({"model_state": sd}, TINY["num_layers"])
    for a, b in zip(jax.tree.leaves(theirs["params"]), jax.tree.leaves(tree["model"])):
        np.testing.assert_array_equal(a, b)
    again = ge2e_from_jax(back, TINY["num_layers"])
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="unconsumed torch keys"):
        ge2e_to_jax(dict(sd, stray=torch.zeros(1)), TINY["num_layers"])
    with pytest.raises(ValueError, match="unexpected top-level keys"):
        ge2e_from_jax(dict(tree, step=0), TINY["num_layers"])


# ---------------------------------------------------------------- the sampler and the loop


def write_frames_tree(root, n_speakers=5, n_utts=(2, 4, 3, 5, 2), seed=0, frames=(22, 40)):
    """Per-speaker directories of (T, 40) power-mel ``.npy`` files; one
    utterance shorter than a partial (edge-tiled by the sampler)."""
    r = np.random.default_rng(seed)
    for s in range(n_speakers):
        d = os.path.join(root, f"spk{s}")
        os.makedirs(d, exist_ok=True)
        for u in range(n_utts[s]):
            n = 12 if (s, u) == (1, 0) else int(r.integers(*frames))
            mel = (r.uniform(0, 1, (n, 40)) ** 4 * (1 + s)).astype(np.float32)
            np.save(os.path.join(d, f"u{u}.npy"), mel)
    return root


@pytest.mark.parametrize("spk_per_batch, utts", [(3, 2), (5, 4), (7, 3)])
def test_sampler_batches_equal_jax(tmp_path, spk_per_batch, utts):
    """The same seed gives the same batches, bit for bit, over enough
    batches to cycle every queue (fewer and more speakers per batch than
    the corpus has, more utterances than a speaker has files)."""
    root = write_frames_tree(str(tmp_path))
    ours = SpeakerVerificationSampler(root, spk_per_batch, utts, T, seed=3)
    theirs = JSampler(root, spk_per_batch, utts, T, seed=3)
    for _ in range(6):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a.shape == (spk_per_batch * utts, T, 40) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_sampler_state_resumes_the_draws(tmp_path):
    """state/load_state: a new sampler loaded with an old one's state draws
    what the old one draws next."""
    root = write_frames_tree(str(tmp_path))
    a = SpeakerVerificationSampler(root, 3, 2, T, seed=1)
    for _ in range(3):
        a.next_batch()
    b = SpeakerVerificationSampler(root, 3, 2, T, seed=99)
    b.load_state(a.state())
    for _ in range(4):
        np.testing.assert_array_equal(a.next_batch(), b.next_batch())


def _loop(root, models, **kw):
    args = dict(clean_data_root=root, models_dir=models, run_id="run", speakers_per_batch=3,
                utterances_per_speaker=2, n_frames=T, learning_rate=1e-3, vis_every=2,
                umap_every=0, save_every=2, backup_every=0, device="cpu")
    return train_speaker_encoder(**dict(args, **kw))


def test_training_loop_resume_equals_a_straight_run(tmp_path):
    """4 steps, then a second call with max_steps 6 that resumes at step 4:
    the weights equal 6 straight steps exactly (the checkpoint keeps Adam
    and the sampler's state); the reports' losses are finite and the EER in
    [0, 1]; the .pt holds model_state and step."""
    root = write_frames_tree(str(tmp_path / "data"))
    first = _loop(root, str(tmp_path / "a"), max_steps=4)
    assert first["step"] == 4 and [r[0] for r in first["reports"]] == [2, 4]
    resumed = _loop(root, str(tmp_path / "a"), max_steps=6)
    straight = _loop(root, str(tmp_path / "b"), max_steps=6)
    assert resumed["step"] == straight["step"] == 6 and len(resumed["reports"]) == 1
    for (n, p), q in zip(resumed["model"].named_parameters(), straight["model"].parameters()):
        assert torch.equal(p, q), n
    assert resumed["reports"][0] == straight["reports"][-1]
    assert all(np.isfinite(lo) and 0 <= eer <= 1 for _, lo, eer in straight["reports"])
    saved = torch.load(straight["model_path"], weights_only=True)
    assert saved["step"] == 6 and "similarity_weight" in saved["model_state"]
    restart = _loop(root, str(tmp_path / "a"), max_steps=2, force_restart=True)
    assert restart["step"] == 2
    assert "batch" in straight["times"]


def _speech(rng, seconds, f0, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h for h in range(1, 8))
    y *= 0.5 * (1 + np.sin(2 * np.pi * 3 * t)) ** 2
    return (0.2 * y / np.abs(y).max() + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def test_clis_on_cpu_preprocess_train_resume_and_serve(tmp_path):
    """preprocess_spk on 3 speakers' 22 050 Hz wavs (one too short to keep),
    train_spk_encoder at full width for 2 steps with the projections, then
    a resumed run to step 3; the .pt loads through cli.inference_vc's
    --spk-encoder loader and embeds a wav."""
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    for s in range(3):
        (raw / f"speaker{s}" / "book").mkdir(parents=True)
        for u in range(2):
            write_wav(str(raw / f"speaker{s}" / "book" / f"{u}.wav"),
                      _speech(rng, 1.9, 110 + 50 * s), 22050)
    write_wav(str(raw / "speaker0" / "short.wav"), _speech(rng, 0.5, 110), 22050)
    out = str(tmp_path / "clean")
    assert preprocess_spk.main([str(raw), "-o", out, "-n", "toy"]) == 6
    assert sorted(os.listdir(os.path.join(out, "speaker0"))) == [
        "_sources.txt", "book_0.npy", "book_1.npy"]
    with open(os.path.join(out, "Log_toy.txt")) as f:
        assert "utterances: 6" in f.read()
    models = str(tmp_path / "models")
    args = ["run", out, "-m", models, "-v", "1", "-u", "2", "-s", "1", "-b", "2",
            "--speakers_per_batch", "3", "--utterances_per_speaker", "2", "--device", "cpu"]
    res = train_spk_encoder.main(args + ["--max_steps", "2"])
    assert res["step"] == 2 and len(res["reports"]) == 2
    assert os.path.exists(os.path.join(models, "run_backups", "run_proj_000002.png"))
    assert os.listdir(os.path.join(models, "run_backups", "bak_000002")) == [
        "step_0000000002.pt"]
    res = train_spk_encoder.main(args + ["--max_steps", "3"])
    assert res["step"] == 3 and [r[0] for r in res["reports"]] == [3]
    model = inference_vc.load_speaker_encoder(res["model_path"], "cpu")
    for k, v in torch.load(res["model_path"], weights_only=True)["model_state"].items():
        assert torch.equal(model.state_dict()[k], v), k
    with torch.no_grad():
        emb = t_spk.embed_utterance(model, _speech(rng, 2.0, 150, sr=16000))
    assert emb.shape == (256,) and abs(float(emb.norm()) - 1) < 1e-5


def test_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_spk_encoder.main(["run", str(tmp_path), "-m", str(tmp_path / "m")])
    assert not os.path.exists(tmp_path / "m")
