"""PyTorch port, the data axis of the TTS and VC trainers: two and four
gloo ranks on the CPU against the port's one-process step on the global
batch and against the JAX package's trainer steps on a 2- and a 4-device
mesh.

One spawn (``tests/torch_trainers_ddp_worker.py``, four processes, one
intra-op thread each, 150 s at most): all four meet at a ``file://`` store
and run each trainer's step on their row of each global batch of 4; then
ranks 0-1 meet at another and run every check on their two rows: one
Grad-TTS step (single- and multi-speaker, MAS on, the crop on), one
HiFi-GAN GAN step, one DiffVC encoder step and one decoder step, and the
checkpoint, stream and CLI checks. The JAX side runs here on two and four
of the 8 virtual CPU devices (``make_mesh(n_devices=N)``, ``shard_batch``,
``replicate``), each step jitted once a mesh, with dropout off
(the JAX models pinned to ``train=False``, as the one-process parity tests
run them) and the JAX draws (offsets, t, z) replayed by the ranks, their
own rows of the global draw. Grad-TTS and DiffVC take Adam at lr 1e-3,
eps 1e-3 on both sides (an update is then a smooth function of its
gradient: at eps 1e-8 a gradient of rounding noise moves its leaf by lr in
either direction); HiFi-GAN its ``make_optimizers`` at lr 2e-4.

Limits: against JAX, losses 1e-5, gradients 1e-4 x max|g| (floored at 1e-6
x the largest, a leaf of rounding noise; JAX's from Adam's first moments),
parameters 2e-5; N ranks against one process on the global batch (the
port drawing at the global shape itself), loss 1e-6 relative and weights
1e-6 x max(1, max|p|).
"""

import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_speech.models.diffvc.vc import DiffVC as JDiffVC
from tpu_speech.models.grad_tts import GradTTS as JGradTTS
from tpu_speech.parallel import mesh as jmesh
from tpu_speech.train import hifigan as j_hifigan
from tpu_speech.train.diffvc import make_dec_train_step, make_enc_train_step
from tpu_speech.train.gradtts import make_train_step
from tpu_speech.train.state import TrainState
from tpu_speech_torch.cli import inference, inference_vc
from tpu_speech_torch.compat.jax_diffvc import diffvc_from_jax, fwd_diffusion_from_jax
from tpu_speech_torch.compat.jax_gradtts import gradtts_from_jax
from tpu_speech_torch.configs import diffvc as vc_cfg
from tpu_speech_torch.configs import gradtts as tts_cfg
from tpu_speech_torch.models.diffvc import FwdDiffusion
from tpu_speech_torch.models.grad_tts import GradTTS
from tpu_speech_torch.models.speaker_encoder import SpeakerEncoder
from tpu_speech_torch.parallel import launch
from tpu_speech_torch.train.gradtts import GradTTSTrainer
from tests import test_torch_diffvc_train as tdv
from tests import test_torch_gradtts_train as tgt
from tests import test_torch_hifigan_train as thg
from tests import torch_trainers_ddp_worker as worker

jax.config.update("jax_default_matmul_precision", "highest")

SPAWN_TIMEOUT = 150
LR, EPS = 1e-3, 1e-3
OUT_SIZE = 16
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _EvalModel:
    """A flax module whose ``apply`` runs with ``train=False`` whatever the
    step asks: the JAX Grad-TTS step applies ``train=True``, and its
    prenet's dropout is fixed at 0.5."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, train=True, rngs=None, **kw):
        return self.module.apply(variables, *args, train=False, **kw)


def _tts_batch(n_spks, seed=0):
    """A global batch of 4 (two rows a rank) with mixed lengths."""
    rng = np.random.default_rng(seed)
    b, t_x, t_y = 4, 12, 32
    batch = {"x": rng.integers(1, tgt.TINY["n_vocab"], size=(b, t_x)).astype(np.int32),
             "x_lengths": np.array([12, 9, 5, 10], np.int32),
             "y": rng.standard_normal((b, t_y, tgt.F)).astype(np.float32),
             "y_lengths": np.array([32, 27, 20, 30], np.int32)}
    if n_spks > 1:
        batch["spk"] = np.array([0, 2, 1, 2], np.int32)
    return batch


def _jax_state(tree, tx, mesh):
    return jmesh.replicate(mesh, TrainState.create({"params": jax.tree.map(jnp.asarray, tree)},
                                                   tx))


def _adam_grads(opt_state, b1=0.9):
    """A first step's gradients from Adam's first moments: g = mu / (1 - b1)."""
    return jax.tree.map(lambda m: np.asarray(m) / (1 - b1), opt_state[0].mu)


def _start(root):
    import torch.multiprocessing as mp

    return mp.start_processes(worker.run, args=(root,), nprocs=4, join=False,
                              start_method="spawn"), time.monotonic(), time.time()


def _join(started) -> None:
    ctx, t0, _ = started
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > SPAWN_TIMEOUT:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the four ranks did not finish within {SPAWN_TIMEOUT} s")


def _cli_job(root):
    """The two CLIs' inputs: a Grad-TTS corpus and a DiffVC corpus with a
    tiny encoder checkpoint, and their config settings for the ranks."""
    tts_root = os.path.join(root, "tts")
    os.makedirs(tts_root)
    filelist = tgt._write_corpus(tts_root, 8)
    tts = dict(tgt.TINY_CLI, train_filelist_path=filelist,
               test_filelist_path=os.path.join(tts_root, "absent.txt"),
               log_dir=os.path.join(root, "tts_logs"), n_spks=1)
    vc_root = os.path.join(root, "vc")
    src, tgt_wav = tdv.write_vc_corpus(vc_root)
    torch.manual_seed(0)
    enc = FwdDiffusion(80, 32, 64, 2, 2, 3, 0.1, 4, 16)
    enc_pt = os.path.join(root, "enc.pt")
    torch.save(enc.state_dict(), enc_pt)
    config = {tts_cfg.__name__: tts, vc_cfg.__name__: dict(tdv.TINY_CLI),
              "tpu_speech_torch.train.diffvc": {"PREVIEW_TIMESTEPS": 2}}
    argv = ["--data-dir", vc_root, "--device", "cpu", "--batch-size", "4", "--epochs", "1",
            "--log-dir", os.path.join(root, "dec_logs"), "--enc-ckpt", enc_pt]
    return dict(cli_config=config, dec_argv=argv, vc_wavs=(src, tgt_wav))


def _jax_steps(job, mesh):
    """Each trainer's JAX step on ``mesh`` from the job's weights and global
    batches: {name: (metrics, gradients, parameters)} as the port names
    them."""
    jax_out = {}
    key = jax.random.PRNGKey(SEED)
    tx = optax.adam(LR, eps=EPS)
    for n_spks in (1, 3):
        step = make_train_step(_EvalModel(JGradTTS(**dict(tgt.TINY, n_spks=n_spks))), tx,
                               OUT_SIZE)
        st, m = step(_jax_state(tgt._jax_params(n_spks), tx, mesh),
                     jmesh.shard_batch(mesh, job[f"tts_batch{n_spks}"]), key)
        jax_out[f"gradtts{n_spks}"] = (
            {k: float(v) for k, v in m.items()},
            gradtts_from_jax(_adam_grads(st.opt_state), tgt.TINY["n_enc_layers"], n_spks),
            gradtts_from_jax(jax.tree.map(np.asarray, st.params["params"]),
                             tgt.TINY["n_enc_layers"], n_spks))

    trees = thg._jax_trees()
    hg_batch = job["hg_batch"]
    gen, mpd, msd = thg._jax_models()
    tx_g, tx_d = j_hifigan.make_optimizers(thg.LR, steps_per_epoch=1)
    state = jmesh.replicate(mesh, j_hifigan.GANTrainState.create(
        *(jax.tree.map(jnp.asarray, trees[k]) for k in ("gen", "mpd", "msd")), tx_g, tx_d))
    st, m = j_hifigan.make_gan_train_step(gen, mpd, msd, tx_g, tx_d, thg.MEL_CFG)(
        state, jmesh.shard_batch(mesh, hg_batch), jax.random.PRNGKey(0))
    grads = thg._jax_grads((st.opt_g[0].mu, st.opt_d[0].mu), None)
    jax_out["hifigan"] = ({k: float(v) for k, v in m.items()},
                          thg._state_dicts(grads[0], grads[1]["mpd"], grads[1]["msd"]),
                          thg._state_dicts(*jax.tree.map(np.asarray, (
                              st.gen, st.disc["mpd"], st.disc["msd"]))))

    st, m = make_enc_train_step(tdv._EncNoDropout(**tdv.ENC), tx)(
        _jax_state(tdv._enc_tree(), tx, mesh), jmesh.shard_batch(mesh, job["enc_batch"]),
        jax.random.PRNGKey(0))
    jax_out["diffvc_enc"] = (
        {k: float(v) for k, v in m.items()},
        fwd_diffusion_from_jax(_adam_grads(st.opt_state), tdv.ENC["layers"]),
        fwd_diffusion_from_jax(jax.tree.map(np.asarray, st.params["params"]), tdv.ENC["layers"]))
    st, m = make_dec_train_step(JDiffVC(**tdv.VC), tx)(
        _jax_state(tdv._vc_tree(), tx, mesh), jmesh.shard_batch(mesh, job["vc_batch"]),
        jax.random.PRNGKey(SEED + 1))
    jax_out["diffvc_dec"] = (
        {k: float(v) for k, v in m.items()},
        diffvc_from_jax(_adam_grads(st.opt_state), tdv.VC["layers"], tdv.VC["use_ref_t"]),
        diffvc_from_jax(jax.tree.map(np.asarray, st.params["params"]), tdv.VC["layers"],
                        tdv.VC["use_ref_t"]))
    return jax_out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The job and the ranks' results (the world of two and the world of
    four); the JAX mesh steps run here while the ranks run."""
    root = str(tmp_path_factory.mktemp("trainers_ddp"))
    job = {"root": root, "world": 2, "lr": LR, "eps": EPS, "seed": SEED,
           "out_size": OUT_SIZE, "tts_cfg": dict(tgt.TINY)}
    key = jax.random.PRNGKey(SEED)
    for n_spks in (1, 3):
        tree = tgt._jax_params(n_spks)
        bt = _tts_batch(n_spks)
        offsets, t, z = tgt._jax_draws(key, bt, OUT_SIZE)
        job.update({f"tts_sd{n_spks}": gradtts_from_jax(tree, tgt.TINY["n_enc_layers"], n_spks),
                    f"tts_batch{n_spks}": bt, f"tts_draws{n_spks}": (offsets, t, z)})
    job["tts_batch1_b"] = _tts_batch(1, seed=1)

    trees = thg._jax_trees()
    g_sd, d_sd = thg._state_dicts(trees["gen"], trees["mpd"], trees["msd"])
    hg_batch = {"wav": np.concatenate([thg._batch(seed=0)["wav"], thg._batch(seed=1)["wav"]])}
    job.update(hg_gen=dict(thg.GEN, n_mels=thg.MEL_CFG["num_mels"]),
               hg_mpd=(thg.PERIODS, thg.MPD_CHANNELS), hg_msd=(2, thg.MSD_SPECS),
               hg_gen_sd=g_sd, hg_disc_sd=d_sd, hg_batch=hg_batch, hg_mel=thg.MEL_CFG,
               hg_lr=thg.LR)

    enc_batch = tdv._enc_batch(lengths=(32, 25, 14, 20))
    vc_batch = tdv._dec_batch(lengths=(32, 27, 16, 22))
    vc_key = jax.random.PRNGKey(SEED + 1)
    job.update(enc_cfg=dict(tdv.ENC), enc_sd=fwd_diffusion_from_jax(tdv._enc_tree(),
                                                                    tdv.ENC["layers"]),
               enc_batch=enc_batch, vc_cfg=dict(tdv.VC),
               vc_sd=diffvc_from_jax(tdv._vc_tree(), tdv.VC["layers"], tdv.VC["use_ref_t"]),
               vc_batch=vc_batch, vc_draws=tdv._jax_draws(vc_key, vc_batch["mel1"].shape))
    job.update(_cli_job(root))
    job["checks"] = list(worker.CHECKS)
    job["checks4"] = list(STEP_CHECKS)
    torch.save(job, os.path.join(root, "job.pt"))
    started = _start(root)

    # ---- the JAX mesh steps, while the ranks run
    jax_out = {n: _jax_steps(job, jmesh.make_mesh(n_devices=n)) for n in (2, 4)}
    _join(started)
    outs = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]
    # the ranks' own time, from the spawn to the last one's results (the JAX
    # steps above may take longer)
    seconds = max(o["finished"] for o in outs) - started[2]
    return types.SimpleNamespace(job=job, jax=jax_out[2], jax4=jax_out[4], ranks=outs[:2],
                                 ranks4=[o["w4"] for o in outs], seconds=seconds)


def _one_process(case, name):
    """The port's one-process run of a check on the whole global batch (run
    once)."""
    cache = case.__dict__.setdefault("one", {})
    if name not in cache:
        job = dict(case.job, root=os.path.join(case.job["root"], "one"))
        os.makedirs(job["root"], exist_ok=True)
        cache[name] = worker.CHECKS[name](job, 0, 1)
    return cache[name]


def _assert_params_close(got, want, rel=1e-6):
    scale = max(1.0, max(float(v.abs().max()) for v in want.values() if v.is_floating_point()))
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=rel * scale, msg=k)


def _assert_grads_close(got, want, rtol=1e-4, floor=1e-6):
    g_max = max(float(g.abs().max()) for g in want.values())
    for k, g_ref in want.items():
        bound = max(rtol * float(g_ref.abs().max()), floor * g_max)
        err = float((got[k] - g_ref).abs().max())
        assert err <= bound, (k, err, bound)


STEPS = ["gradtts1", "gradtts3", "hifigan", "diffvc_enc", "diffvc_dec"]
# the checks the world of four runs: each step, with the JAX draws replayed
# where the step draws
STEP_CHECKS = STEPS + ["gradtts1_jax", "gradtts3_jax", "diffvc_dec_jax"]


def test_the_ranks_finish_within_their_timeout(case):
    assert case.seconds < SPAWN_TIMEOUT


@pytest.mark.parametrize("name", STEPS)
def test_two_ranks_equal_the_one_process_global_batch_step(case, name):
    """Each trainer's step over two ranks, the port drawing at the global
    shape: every metric within 1e-6 relative of one process's on the whole
    batch, and the weights (both networks of the GAN) within 1e-6 x
    max(1, max|p|); both ranks hold them."""
    one = _one_process(case, name)
    for r in case.ranks:
        got = r[name]
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, err_msg=k)
        _assert_params_close(got["sd"], one["sd"])
        if name == "hifigan":
            _assert_params_close(got["disc_sd"], one["disc_sd"])


@pytest.mark.parametrize("name", STEPS)
def test_the_ranks_hold_equal_weights_bit_for_bit(case, name):
    a, b = (r[name] for r in case.ranks)
    for key in ("sd", "disc_sd") if name == "hifigan" else ("sd",):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), k


@pytest.mark.parametrize("name", ["gradtts1", "gradtts3", "hifigan", "diffvc_enc",
                                  "diffvc_dec"])
def test_two_ranks_equal_the_jax_mesh_step(case, name):
    """Against the JAX trainer's step on a 2-device mesh with the same
    global batch (JAX's draws replayed, each rank its rows): the losses
    within 1e-5 relative, the summed and clipped gradients within 1e-4 x
    max|g| leaf by leaf, the parameters after the update within 2e-5."""
    _assert_equals_jax_step(case.ranks[0], case.jax[name], name)


def _assert_equals_jax_step(rank, jax_step, name):
    got = rank[name + ("_jax" if name in ("gradtts1", "gradtts3", "diffvc_dec") else "")]
    metrics, grads, params = jax_step
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    if name == "hifigan":
        (g_gen, g_disc), (p_gen, p_disc) = grads, params
        _assert_grads_close(got["grads"], g_gen)
        _assert_grads_close(got["disc_grads"], g_disc)
        pairs = ((got["sd"], p_gen), (got["disc_sd"], p_disc))
    else:
        _assert_grads_close(got["grads"], grads)
        pairs = ((got["sd"], params),)
    for sd, want in pairs:
        for k, v in want.items():
            err = float((sd[k] - v).abs().max())
            assert err <= 2e-5, (k, err)


@pytest.mark.parametrize("name", STEPS)
def test_four_ranks_equal_the_one_process_global_batch_step(case, name):
    """Each trainer's step over four ranks of one row each, the port
    drawing at the global shape: every metric within 1e-6 relative of one
    process's on the whole batch, the weights within 1e-6 x max(1, max|p|),
    and the four ranks' weights equal bit for bit."""
    one = _one_process(case, name)
    for r in case.ranks4:
        got = r[name]
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, err_msg=k)
        for key in ("sd", "disc_sd") if name == "hifigan" else ("sd",):
            _assert_params_close(got[key], one[key])
            for k, v in case.ranks4[0][name][key].items():
                assert torch.equal(got[key][k], v), k


@pytest.mark.parametrize("name", STEPS)
def test_four_ranks_equal_the_jax_mesh_step(case, name):
    """Against the JAX trainer's step on a 4-device mesh, at the bounds of
    the two-rank test."""
    _assert_equals_jax_step(case.ranks4[0], case.jax4[name], name)


def test_every_draw_is_the_global_draw_sliced(monkeypatch):
    """A rank's draws at world 2 are its rows of the one-process draws from
    the same generator: t and z of the diffusion losses (Grad-TTS's and the
    DiffVC decoder's), and the rows ``global_rows`` gives."""
    from tpu_speech_torch.models.diffusion import draw_t_z
    from tpu_speech_torch.parallel import mesh

    x0 = torch.zeros(4, 3, 5)
    whole = draw_t_z(x0, 1e-5, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(mesh.distributed, "process_count", lambda: 2)
    for rank in (0, 1):
        monkeypatch.setattr(mesh.distributed, "process_index", lambda r=rank: r)
        n, rows = mesh.global_rows(2)
        assert n == 4 and rows == slice(2 * rank, 2 * rank + 2)
        part = draw_t_z(x0[rows], 1e-5, generator=torch.Generator().manual_seed(3))
        assert torch.equal(part[0], whole[0][rows]) and torch.equal(part[1], whole[1][rows])


def test_the_mas_path_and_the_losses_divide_by_global_counts(case):
    """The ranks ran MAS on their own rows and their loss terms add up to
    the global ones: each rank reports the one-process duration, prior and
    diffusion losses, not its half's."""
    one = _one_process(case, "gradtts1")
    half = dict(case.job, tts_batch1={k: v[:2] for k, v in case.job["tts_batch1"].items()})
    local = worker.CHECKS["gradtts1"](half, 0, 1)
    for k in ("dur_loss", "prior_loss", "diff_loss"):
        assert case.ranks[1]["gradtts1"]["metrics"][k] == pytest.approx(one["metrics"][k],
                                                                        rel=1e-6)
        assert local["metrics"][k] != pytest.approx(one["metrics"][k], rel=1e-3)


def test_device_streams_differ_across_ranks(case):
    """Dropout's default generator: rank 0 draws what one process draws,
    rank 1 something else."""
    a, b = (r["streams"]["draw"] for r in case.ranks)
    torch.manual_seed(SEED)
    assert torch.equal(a, torch.rand(8)) and not torch.equal(a, b)


def test_a_checkpoint_of_two_ranks_resumes_in_one_process(case):
    """Rank 0 wrote each epoch's checkpoint with both ranks' generators; one
    process resumes from the last one with the two ranks' weights; the
    ranks logged the same global losses."""
    out = case.ranks[0]["ckpt"]
    assert out["iteration"] == 4 and case.ranks[1]["ckpt"]["losses"] == out["losses"]
    ckpts = sorted(os.listdir(os.path.join(out["dir"], "ckpt")))
    assert ckpts == ["step_0000000002.pt", "step_0000000004.pt"]
    st = torch.load(os.path.join(out["dir"], "ckpt", ckpts[-1]), weights_only=False)
    assert len(st["ranks"]) == 2
    assert not torch.equal(st["ranks"][0]["rng_cpu"], st["ranks"][1]["rng_cpu"])
    torch.manual_seed(SEED)
    trainer = GradTTSTrainer(GradTTS(**dict(tgt.TINY, n_spks=1)),
                             os.path.join(case.job["root"], "resumed"), seed=SEED)
    trainer.ckpt = type(trainer.ckpt)(os.path.join(out["dir"], "ckpt"))
    assert trainer.resume_if_exists() and trainer.iteration == 4
    _assert_params_close(dict(trainer.model.state_dict()), out["sd"], rel=0)
    assert torch.equal(torch.get_rng_state(), st["ranks"][0]["rng_cpu"])


def test_cli_runs_over_two_ranks_write_pts_that_the_inference_clis_load(case, tmp_path):
    """``cli.train`` and ``cli.train_dec`` in the two ranks (config settings
    carried by ``launch.apply_snapshot``): one reference-named ``.pt`` each,
    written by rank 0, the global step count (8 utterances / batch 4; 20 / 4),
    equal weights on the ranks; ``cli.inference`` and ``cli.inference_vc``
    serve them."""
    a, b = (r["clis"] for r in case.ranks)
    assert a["tts"]["iteration"] == b["tts"]["iteration"] == 2
    assert a["dec"]["iteration"] == b["dec"]["iteration"] == 5
    assert a["tts"]["epochs"] == b["tts"]["epochs"] and a["dec"]["losses"] == b["dec"]["losses"]
    texts = str(tmp_path / "texts.txt")
    with open(texts, "w") as f:
        f.write("hello quick world\n")
    old = {k: getattr(tts_cfg, k) for k in tgt.TINY_CLI}
    try:
        for k, v in tgt.TINY_CLI.items():
            setattr(tts_cfg, k, v)
        out = inference.main(["-f", texts, "-c", a["tts"]["state_dict"], "--out-dir",
                              str(tmp_path / "out"), "--cmudict", "", "--device", "cpu",
                              "--hifigan", str(tmp_path / "absent.pt")])
    finally:
        for k, v in old.items():
            setattr(tts_cfg, k, v)
    assert len(out["samples"]) == 1
    spk = SpeakerEncoder().init_weights(torch.Generator().manual_seed(1))
    spk_pt = str(tmp_path / "spk.pt")
    torch.save({"model_state": spk.state_dict(), "step": 1}, spk_pt)
    src, tgt_wav = case.job["vc_wavs"]
    old = {k: getattr(vc_cfg, k) for k in tdv.TINY_CLI}
    try:
        for k, v in tdv.TINY_CLI.items():
            setattr(vc_cfg, k, v)
        vc = inference_vc.main(["-s", src, "-t", tgt_wav, "-c", a["dec"]["state_dict"],
                                "--spk-encoder", spk_pt, "-n", "2", "--device", "cpu",
                                "-o", str(tmp_path / "out.wav")])
    finally:
        for k, v in old.items():
            setattr(vc_cfg, k, v)
    assert vc["finite"]["mel"]


def test_a_batch_the_ranks_do_not_divide_stops(monkeypatch):
    """A global batch of 5 over 2 ranks stops before any work."""
    monkeypatch.setattr(launch.distributed, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="does not divide by the 2 ranks"):
        launch.check_batch(5)
    launch.check_batch(4)


def test_config_snapshots_carry_plain_settings():
    snap = launch.config_snapshot([tts_cfg])[tts_cfg.__name__]
    assert snap["batch_size"] == tts_cfg.batch_size and "model_kwargs" not in snap
