"""PyTorch port, the model axis: JAX's TP placement (``shard_params_tp``) and
the (data, seq, model) mesh over four gloo ranks on the CPU, against the
one-process step and the JAX package's single-device step.

One spawn (``tests/torch_tp_worker.py``, four processes, one intra-op
thread each, 150 s at most) runs every check in one world of four: the
meshes' rank layouts; the tiny Grad-TTS step (eval mode, MAS on, the crop,
JAX's draws replayed, Adam lr 1e-3 eps 1e-3 as ``test_torch_trainers_ddp``)
on (data 2, model 2), replicated and TP-placed, and Novograd TP-placed; a
TP checkpoint resumed; a whole tensor loaded into a 2-D mesh's shard; the
tiny SPIRAL pretrain step (AdamW, the clip, JAX's negatives; dither,
dropout and layerdrop off) on (data 1, seq 2, model 2), replicated and
TP-placed. JAX runs here meanwhile: each step jitted once on one device,
and ``shard_params_tp`` on the conftest's 8 devices as (data 4, model 2),
placement only.

Limits (ROADMAP "Parity so far"): the loss within 1e-5 relative, the
gradients 1e-4 x max|g| (floored at 1e-6 x the largest, a leaf of rounding
noise), the parameters after the update 2e-5; against the one-process port
step, loss 1e-6 relative and weights 1e-6 x max(1, max|p|); a resumed TP
run equals a straight one bit for bit.
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

from tpu_speech.models.grad_tts import GradTTS as JGradTTS
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.parallel import mesh as jmesh
from tpu_speech.train import optim as joptim
from tpu_speech.train import spiral as jspiral
from tpu_speech.train.gradtts import make_train_step
from tpu_speech_torch.compat.jax_gradtts import gradtts_from_jax
from tpu_speech_torch.compat.jax_spiral import st2vec_from_jax
from tpu_speech_torch.models.grad_tts import GradTTS
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, exclude_self
from tpu_speech_torch.parallel import mesh
from tests import test_torch_gradtts_train as tgt
from tests import test_torch_pretrain as tpt
from tests import torch_tp_worker as worker
from tests.test_torch_seq_parallel import SPEC_LEN, _batch as _spiral_batch
from tests.test_torch_trainers_ddp import (
    EPS,
    LR,
    OUT_SIZE,
    SEED,
    _adam_grads,
    _EvalModel,
    _jax_state,
    _tts_batch,
)

jax.config.update("jax_default_matmul_precision", "highest")

SPAWN_TIMEOUT = 150
CLIP = 4.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _spiral_job():
    """The tiny pretrain config, its JAX weights, a batch of 8 and JAX's
    negatives (``test_torch_seq_parallel``'s operating point)."""
    cfg, jcfg = tpt._tiny()
    jmodel = jst2vec.ST2VecEncoder(jcfg)
    init = jspiral.init_spiral_state(jmodel, jax.random.PRNGKey(0), (2, SPEC_LEN, 16),
                                     optax.sgd(1.0))
    trees = tuple(jax.tree.map(np.asarray, t) for t in (init.params, init.batch_stats,
                                                        init.teacher))
    batch = _spiral_batch(jcfg)
    key = jax.random.PRNGKey(7)
    lens = tpt._student_feat_lens(batch["p_wav_lens"])
    neg = exclude_self(torch.tensor(tpt._jax_raw_negative_indices(
        jax.random.fold_in(key, 3), lens, SPEC_LEN // 8, jcfg.n_negatives)))
    return dict(cfg=cfg, sd=st2vec_from_jax(*trees), batch=batch, neg=neg, clip=CLIP), \
        (jmodel, jcfg, trees, key)


def _jax_gradtts(job, tree):
    """JAX's Grad-TTS step on one device: (metrics, gradients, parameters)
    named as the port's."""
    m1 = jmesh.make_mesh(n_devices=1)
    tx = optax.adam(LR, eps=EPS)
    step = make_train_step(_EvalModel(JGradTTS(**dict(tgt.TINY, n_spks=1))), tx, OUT_SIZE)
    st, m = step(_jax_state(tree, tx, m1), jmesh.shard_batch(m1, job["tts_batch"]),
                 jax.random.PRNGKey(SEED))
    n = tgt.TINY["n_enc_layers"]
    return ({k: float(v) for k, v in m.items()},
            gradtts_from_jax(_adam_grads(st.opt_state), n, 1),
            gradtts_from_jax(jax.tree.map(np.asarray, st.params["params"]), n, 1))


def _jax_pretrain(job, jax_side):
    """JAX's pretrain step on one device with the config's AdamW: (loss,
    gradients from Adam's first moments, the state_dict after the step)."""
    jmodel, jcfg, (params, bstats, teacher), key = jax_side
    tx = joptim.make_optimizer(job["cfg"].model.optim, 100)
    state = jspiral.SpiralTrainState(jnp.zeros((), jnp.int32), params, bstats, teacher,
                                     tx.init(params))
    new, metrics = jspiral.make_pretrain_step(jmodel, jcfg, tx, grad_clip=CLIP)(
        state, job["batch"], key)
    b1 = job["cfg"].model.optim.betas[0]
    grads = st2vec_from_jax(_adam_grads(new.opt_state, b1), bstats)
    after = st2vec_from_jax(*jax.tree.map(np.asarray, (new.params, new.batch_stats,
                                                        new.teacher)))
    return float(metrics["loss"]), grads, after


def _jax_marked(tree, mp=2):
    """JAX's ``shard_params_tp`` on (data 8 / mp, model mp) of the virtual
    devices: a tree of 1.0 where a leaf is split over ``model``, else 0.0."""
    placed = jmesh.shard_params_tp(jmesh.make_mesh(n_devices=8, model_parallel=mp), tree)
    return jax.tree.map(lambda a: np.full(a.shape, float(jmesh.MODEL_AXIS in a.sharding.spec),
                                          np.float32), placed)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    tree = tgt._jax_params(1)
    batch = _tts_batch(1)
    job = {"root": root, "lr": LR, "eps": EPS, "seed": SEED, "out_size": OUT_SIZE,
           "tts_cfg": dict(tgt.TINY), "tts_batch": batch,
           "tts_sd": gradtts_from_jax(tree, tgt.TINY["n_enc_layers"], 1),
           "tts_draws": tgt._jax_draws(jax.random.PRNGKey(SEED), batch, OUT_SIZE)}
    spiral, jax_side = _spiral_job()
    job.update(spiral)
    torch.save(job, os.path.join(root, "job.pt"))
    started = _start(root)

    # ---- JAX, while the ranks run
    jax_out = {"gradtts": _jax_gradtts(job, tree), "pretrain": _jax_pretrain(job, jax_side)}
    params, bstats, teacher = jax_side[2]
    marked = {"gradtts": gradtts_from_jax(_jax_marked(tree), tgt.TINY["n_enc_layers"], 1)}
    spiral_marks = _jax_marked({"params": params, "teacher": teacher})
    marked["spiral"] = st2vec_from_jax(spiral_marks["params"],
                                       jax.tree.map(np.zeros_like, bstats),
                                       spiral_marks["teacher"])
    _join(started)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    seconds = max(r["finished"] for r in ranks) - started[2]
    return types.SimpleNamespace(job=job, jax=jax_out, marked=marked, ranks=ranks,
                                 seconds=seconds, one={})


def _one_process(case, name):
    if name not in case.one:
        kind, _, opt = name.partition(":")
        case.one[name] = (worker.gradtts(case.job, "one", opt or "adam", steps=2 if opt else 1)
                          if kind == "gradtts" else worker.pretrain(case.job, "one"))
    return case.one[name]


def _assert_params_close(got, want, rel):
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


def test_the_ranks_finish_within_their_timeout(case):
    assert case.seconds < SPAWN_TIMEOUT


@pytest.mark.parametrize("sp,mp", [(1, 2), (2, 2), (1, 4)])
def test_the_model_axis_lays_ranks_out_as_jax(case, sp, mp):
    """Each rank's coordinates on (data, [seq,] model) are its device's
    position in JAX's mesh of 4 devices; its data coordinate is its data
    index, and its batch group is the ranks of its model coordinate."""
    jm = jmesh.make_mesh(n_devices=4, seq_parallel=sp, model_parallel=mp)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, out in enumerate(case.ranks):
        got = out["layouts"][(sp, mp)]
        assert got["names"] == tuple(jm.axis_names)
        assert got["coord"] == tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert got["data"] == (got["coord"][0], jm.shape["data"])
        assert got["batch"] == 4 // mp
    assert all(out["layouts"]["cleared"] == ((r, 4), 4) for r, out in enumerate(case.ranks))


@pytest.mark.parametrize("model", ["gradtts", "spiral"])
def test_tp_shards_exactly_what_jax_marks(case, model):
    """``tp_shardings`` at M = 2 marks the parameters whose leaves JAX's
    ``shard_params_tp`` splits over ``model`` (the teacher's too), and the
    TP ranks hold exactly those as shards."""
    port = (GradTTS(**case.job["tts_cfg"]) if model == "gradtts"
            else ST2VecEncoder(case.job["cfg"].model.encoder, pretraining=True))
    plan = mesh.tp_shardings(2, port)
    want = {k for k, v in case.marked[model].items()
            if k in plan and float(v.min()) == 1.0}
    assert all(float(v.max()) == 0.0 for k, v in case.marked[model].items()
               if k in plan and k not in want)
    got = {k for k, s in plan.items() if s != mesh.REPLICATED}
    assert got == want and want and len(want) < len(plan)
    check = "gradtts_tp" if model == "gradtts" else "pretrain_tp"
    for r in case.ranks:
        assert set(r[check]["sharded"]) == want


@pytest.mark.parametrize("placement", ["replicated", "tp"])
def test_gradtts_step_on_data2_model2_equals_one_process_and_jax(case, placement):
    """The Grad-TTS step on (data 2, model 2), each model pair on its data
    coordinate's two rows: every metric against the one-process step (1e-6
    relative) and JAX's (1e-5), the clipped gradients against JAX's (1e-4 x
    max|g|), the weights after Adam against one process's (1e-6 x max(1,
    max|p|)) and JAX's (2e-5)."""
    one = _one_process(case, "gradtts")
    metrics, grads, params = case.jax["gradtts"]
    for r in case.ranks:
        got = r[f"gradtts_{placement}"]
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=1e-6, err_msg=k)
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=1e-5, err_msg=k)
        _assert_grads_close(got["grads"], grads)
        _assert_params_close(got["sd"], one["sd"], 1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(got["sd"][k].numpy(), v.numpy(), atol=2e-5, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("placement", ["replicated", "tp"])
def test_spiral_pretrain_on_data1_seq2_model2_equals_one_process_and_jax(case, placement):
    """The pretrain step on (data 1, seq 2, model 2), half the frames a
    rank: the loss against one process (1e-6 relative) and JAX (1e-5), the
    clipped gradients against JAX's (1e-4 x max|g|), the student, teacher
    and BatchNorm statistics after AdamW and the EMA against one process's
    (1e-6 x max(1, max|p|)) and JAX's (2e-5)."""
    one = _one_process(case, "pretrain")
    loss, grads, after = case.jax["pretrain"]
    for r in case.ranks:
        got = r[f"pretrain_{placement}"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert got["frames"] == {k: v // 2 for k, v in one["frames"].items()}
        _assert_grads_close(got["grads"], {k: v for k, v in grads.items()
                                           if k in got["grads"]})
        assert set(got["grads"]) < set(grads)
        _assert_params_close(got["sd"], one["sd"], 1e-6)
        for k, v in after.items():
            if v.is_floating_point():
                np.testing.assert_allclose(got["sd"][k].numpy(), v.numpy(), atol=2e-5, rtol=0,
                                           err_msg=k)


def test_novograd_sharded_over_two_model_ranks_equals_novograd_whole(case):
    """Two Novograd steps with the TP-placed Grad-TTS (a sharded leaf's
    norm summed over its two model ranks) against the same two steps whole
    in one process: weights within 1e-6 x max(1, max|p|)."""
    one = _one_process(case, "gradtts:novograd")
    for r in case.ranks:
        got = r["gradtts_tp_novograd"]
        for a, b in zip(got["metrics"], one["metrics"]):
            for k, v in b.items():
                np.testing.assert_allclose(a[k], v, rtol=1e-6, err_msg=k)
        _assert_params_close(got["sd"], one["sd"], 1e-6)


def test_a_tp_checkpoint_resumes_equal_to_a_straight_run(case):
    """The state after one TP step gathered whole (weights, Adam's moments,
    the count), loaded shard by shard into a fresh TP-placed model: its
    second step equals the straight run's bit for bit."""
    for r in case.ranks:
        ck = r["checkpoint"]
        assert ck["metrics"][0] == ck["metrics"][1]
        assert ck["straight"].keys() == ck["resumed"].keys()
        for k, v in ck["straight"].items():
            assert torch.equal(v, ck["resumed"][k]), k


def test_load_full_takes_the_shard_of_a_2d_mesh(case):
    """A whole tensor loaded into one sharded along dim 1 over the model
    ranks of the (batch, model) mesh: each rank holds its model
    coordinate's chunk, and the gathered tensor is the whole one."""
    full = torch.arange(24.0).reshape(4, 6)
    for r in case.ranks:
        got = r["load_2d"]
        assert torch.equal(got["local"], full[:, 3 * got["model"]:3 * got["model"] + 3])
        assert torch.equal(got["whole"], full)
    assert [r["load_2d"]["model"] for r in case.ranks] == [0, 1, 0, 1]


def test_tp_ranks_hold_a_share_of_the_weights_and_moments(case):
    """A TP rank holds the replicated leaves whole and half of each split
    one: fewer parameter and moment bytes than a replicated rank."""
    for r in case.ranks:
        for step in ("gradtts", "pretrain"):
            tp, rep = r[f"{step}_tp"]["bytes"], r[f"{step}_replicated"]["bytes"]
            assert tp[0] < rep[0] and tp[1] < rep[1] and 2 * tp[0] > rep[0], (step, tp, rep)
