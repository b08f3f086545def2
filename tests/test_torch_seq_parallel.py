"""PyTorch port, the seq axis: SPIRAL pretraining with the encoders' time axis
split over gloo ranks on the CPU, against the one-process step on the global
batch and the JAX package's step on a (data, seq) mesh.

At ``tests/test_distributed.py::test_sequence_parallel_matches_dp``'s
operating point: the tiny pretrain config (dither, dropout and layerdrop
off), a global batch of 8 crops of 8000 samples, 64 spectrogram frames. One
spawn (``tests/torch_seq_worker.py``, four processes, one intra-op thread
each, 150 s at most) runs (data 1, seq 2) in two worlds of two ranks, then
(data 2, seq 2) and (data 1, seq 4) in one world of four. JAX's negatives
are replayed (a data group's rows, every frame); the JAX side runs here on
2 and 4 of the 8 virtual CPU devices (``make_mesh(n_devices=N,
seq_parallel=2)``), each step jitted once.

Limits: against the one-process step, loss 1e-6 relative and weights 1e-6 x
max(1, max|p|); against JAX, loss 1e-4 (the bound of JAX's own seq test),
gradients 1e-4 x max|g| (SGD(1) steps, whose update is the clipped gradient)
and AdamW parameters 2e-5; bf16 by the 2x rule of the step parity tests.
"""

import copy
import dataclasses
import json
import os
import time
import types

import jax
import numpy as np
import optax
import pytest
import torch

from tpu_speech.compat import torch_spiral
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.parallel import mesh as jmesh
from tpu_speech.train import optim as joptim
from tpu_speech.train import spiral as jspiral
from tpu_speech.train.spiral_runner import _lr_scale
from tpu_speech_torch.compat.jax_spiral import st2vec_from_jax
from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char, spiral_tiny_pretrain
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.parallel import mesh
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner
from tpu_speech_torch.text.tokenizers import CharTokenizer
from tests import test_torch_pretrain as tpt
from tests import torch_seq_worker as worker

jax.config.update("jax_default_matmul_precision", "highest")

SR = 16000
B, N_SAMPLES, SPEC_LEN = 8, 8000, 64
CLIP = 4.0
SPAWN_TIMEOUT = 150


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(jcfg):
    rng = np.random.default_rng(0)
    wavs = (rng.standard_normal((B, N_SAMPLES)) * 0.1).astype(np.float32)
    lens = np.full((B,), N_SAMPLES, np.int32)
    lens[3], lens[6] = 6000, 7100  # padded rows: the pad masks read global positions
    wavs[3, 6000:] = wavs[6, 7100:] = 0
    return jspiral.host_augment_batch(jcfg, wavs, lens, wavs * 0.9 + 0.01, lens, SPEC_LEN,
                                      np.random.default_rng(1))


def _toy_manifest(root, n=8, name="manifest", seconds=1.2):
    """``n`` wavs of ``seconds`` + 0.05 i: longer than the tiny config's
    16 000-sample crop, so the loader draws a crop offset for each."""
    r = np.random.default_rng(0 if name == "manifest" else 1)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        for i in range(n):
            wav = os.path.join(root, f"{name}{i}.wav")
            dur = seconds + 0.05 * i
            write_wav(wav, (r.standard_normal(int(SR * dur)) * 0.1).astype(np.float32), SR)
            f.write(json.dumps({"audio_filepath": wav, "duration": dur, "text": "a"}) + "\n")
    return path


def _start(root):
    import torch.multiprocessing as mp

    return mp.start_processes(worker.run, args=(root,), nprocs=4, join=False,
                              start_method="spawn"), time.monotonic()


def _join(started) -> float:
    ctx, t0 = started
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > SPAWN_TIMEOUT:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the four ranks did not finish within {SPAWN_TIMEOUT} s")
    return time.monotonic() - t0


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    cfg, jcfg = tpt._tiny()
    jmodel = jst2vec.ST2VecEncoder(jcfg)
    init = jspiral.init_spiral_state(jmodel, jax.random.PRNGKey(0), (2, SPEC_LEN, 16),
                                     optax.sgd(1.0))
    params, bstats, teacher = (jax.tree.map(np.asarray, t)
                               for t in (init.params, init.batch_stats, init.teacher))
    batch = _batch(jcfg)
    key = jax.random.PRNGKey(7)
    lens = tpt._student_feat_lens(batch["p_wav_lens"])
    from tpu_speech_torch.models.spiral.st2vec import exclude_self

    neg = exclude_self(torch.tensor(tpt._jax_raw_negative_indices(
        jax.random.fold_in(key, 3), lens, SPEC_LEN // 8, jcfg.n_negatives)))
    drop_cfg, _ = tpt._tiny(attention_dropout=0.1, layerdrop=0.5)
    drop_cfg.model.encoder = dataclasses.replace(drop_cfg.model.encoder, dither=1e-5)
    run_cfg = spiral_tiny_pretrain()
    # four loader threads a rank and a noise manifest: the crops and the
    # noise differ from one process to the next
    run_cfg.model.train_ds.manifest_filepath = _toy_manifest(root)
    run_cfg.model.train_ds.num_workers = 4
    run_cfg.model.train_ds.noise_manifest = _toy_manifest(root, 3, "noise", 0.5)
    run_cfg.model.validation_ds.manifest_filepath = run_cfg.model.train_ds.manifest_filepath
    run_cfg.model.validation_ds.num_workers = 4
    run_cfg.model.train_ds.max_duration = run_cfg.model.validation_ds.max_duration = 2.0
    run_cfg.model.expected_gpu_num = 8
    job = {"root": root, "cfg": cfg, "drop_cfg": drop_cfg, "sd": st2vec_from_jax(
        params, bstats, teacher), "batch": batch, "neg": neg, "clip": CLIP, "run_cfg": run_cfg}
    torch.save(job, os.path.join(root, "job.pt"))
    started = _start(root)

    jax_out = {}
    for n_dev in (2, 4):
        m = jmesh.make_mesh(n_devices=n_dev, seq_parallel=2)
        for name, tx in (("sgd", optax.sgd(1.0)),
                         ("adamw", joptim.make_optimizer(cfg.model.optim, 100))):
            state = jmesh.replicate(m, jspiral.SpiralTrainState(
                jax.numpy.zeros((), jax.numpy.int32), params, bstats, teacher,
                tx.init(params)))
            new, metrics = jspiral.make_pretrain_step(jmodel, jcfg, tx, grad_clip=CLIP, mesh=m)(
                state, jmesh.shard_batch(m, batch), key)
            jax_out[(n_dev, name)] = jax.device_get((new.params, new.batch_stats, new.teacher,
                                                     metrics))
    seconds = _join(started)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return types.SimpleNamespace(job=job, jax=jax_out, ranks=ranks, seconds=seconds,
                                 params=params)


def _one_process(case, kind, cfg_key="cfg"):
    cache = case.__dict__.setdefault("one", {})
    if (kind, cfg_key) not in cache:
        cache[(kind, cfg_key)] = worker.pretrain(case.job, 0, kind, cfg_key)
    return cache[(kind, cfg_key)]


def _assert_params_close(got, want, rel=1e-6):
    scale = max(1.0, max(float(v.abs().max()) for v in want.values() if v.is_floating_point()))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=rel * scale, msg=k)


def _trees(sd):
    return torch_spiral.convert_st2vec({k: v.numpy() for k, v in sd.items()})


# (rank indices, result key): the (data 1, seq 2) world of ranks 0-1, then
# the world of four at (data 2, seq 2) and (data 1, seq 4)
MESHES = {"d1s2": ((0, 1), "s2"), "d2s2": ((0, 1, 2, 3), "d2s2"),
          "d1s4": ((0, 1, 2, 3), "d1s4")}


def test_the_ranks_finish_within_their_timeout(case):
    assert case.seconds < SPAWN_TIMEOUT


@pytest.mark.parametrize("name", sorted(MESHES))
def test_seq_step_equals_the_one_process_global_batch_step(case, name):
    """SGD(1) with the clip: every rank's loss within 1e-6 of one process's
    on the whole batch, and the weights (BatchNorm's statistics and the
    teacher included) within 1e-6 x max(1, max|p|)."""
    one = _one_process(case, "sgd")
    ranks, key = MESHES[name]
    for r in ranks:
        got = case.ranks[r][key + "_sgd"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        assert got["acc"] == pytest.approx(one["acc"], abs=1e-6)
        _assert_params_close(got["sd"], one["sd"])


@pytest.mark.parametrize("name", ["d1s2", "d2s2"])
def test_seq_step_equals_the_jax_seq_mesh_step(case, name):
    """Against JAX's step on the (data, seq) mesh of 2 and 4 devices: the
    loss within 1e-4, the SGD(1) step's clipped gradients within 1e-4 x
    max|g|, and the AdamW step's parameters, BatchNorm statistics and EMA
    teacher within 2e-5."""
    ranks, key = MESHES[name]
    n_dev = len(ranks)
    want_params, _, _, jm = case.jax[(n_dev, "sgd")]
    got = case.ranks[0][key + "_sgd"]
    assert abs(got["loss"] - float(jm["loss"])) < 1e-4
    tpt._assert_grads_close(tpt._sgd_grads(case.params, _trees(got["sd"])[0]),
                            tpt._sgd_grads(case.params, want_params))
    want = case.jax[(n_dev, "adamw")]
    got = case.ranks[0][key + "_adamw"]
    assert abs(got["loss"] - float(want[3]["loss"])) < 1e-4
    for g, w in zip(_trees(got["sd"]), want[:3]):
        g, w = dict(tpt._leaves(g)), dict(tpt._leaves(w))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=2e-5, rtol=0, err_msg="/".join(k))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_each_rank_holds_its_share_of_the_frames_at_the_anchors(case, name):
    """The spectrograms (64 frames), the teacher's shifted input (64 + 2 x
    max_shift x 8), the targets and the predictions (64 / 8) hold T / seq
    frames on every rank; one process holds them whole."""
    one = _one_process(case, "sgd")["frames"]
    assert one == {"specs": 64, "teacher_specs": 96, "targets": 8, "pred": 8}
    ranks, key = MESHES[name]
    s = 4 if name == "d1s4" else 2
    for r in ranks:
        assert case.ranks[r][key + "_sgd"]["frames"] == {k: v // s for k, v in one.items()}


def test_the_ranks_hold_equal_weights_bit_for_bit(case):
    for name in ("d2s2_sgd", "d2s2_adamw", "d1s4_sgd"):
        a = case.ranks[0][name]["sd"]
        for r in (1, 2, 3):
            for k in a:
                assert torch.equal(a[k], case.ranks[r][name]["sd"][k]), (name, k)


def test_dropout_layerdrop_and_dither_draw_the_unsharded_bits(case):
    """AdamW with attention dropout 0.1, layerdrop 0.5, the transformers'
    dropout and dither on, the negatives drawn: the seq group (ranks 2-3,
    data group 0's generators) draws what one process draws on the whole
    batch (dither on the whole wavs, each dropout mask and the negatives at
    the global shape, K2's hash by global frame), so the step is the
    one-process step within 1e-6."""
    one = _one_process(case, "dropout", "drop_cfg")
    for r in (2, 3):
        got = case.ranks[r]["s2_dropout"]
        assert got["layers"] == one["layers"] and got["layers"] != (4, 4)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        _assert_params_close(got["sd"], one["sd"])


def test_bf16_seq_step_within_the_2x_rule(case):
    """bf16 at (data 1, seq 2) against the fp32 one-process step: within
    twice the one-process bf16 step's error, the loss and each large
    gradient leaf."""
    fp32, bf16 = _one_process(case, "sgd"), _one_process(case, "bf16")
    got = case.ranks[0]["s2_bf16"]
    l32, l1, l2 = fp32["loss"], bf16["loss"], got["loss"]
    assert abs(l2 - l32) <= 2 * abs(l1 - l32) + 5e-3 * abs(l32), (l2, l1, l32)
    init = case.job["sd"]
    g32 = {k: fp32["sd"][k] - init[k] for k in fp32["sd"]
           if fp32["sd"][k].is_floating_point() and "running" not in k}
    g_max = max(float(g.abs().max()) for g in g32.values())
    for k, g in g32.items():
        if float(g.abs().max()) < 1e-2 * g_max:
            continue
        e2 = float((got["sd"][k] - init[k] - g).norm())
        e1 = float((bf16["sd"][k] - init[k] - g).norm())
        assert e2 <= 2 * e1 + 1e-2 * float(g.norm()), (k, e2, e1)


def test_halo_gather_and_local_frames_against_the_whole_tensor(case):
    """``halo`` gives each rank its window of the zero-padded whole tensor,
    and its backward the whole computation's gradient; ``gather_time``
    gives the whole tensor and its backward the sum of the ranks' output
    gradients, each rank its frames; ``local_frames`` slices and its
    backward pads with zeros."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 3, generator=g)
    w_halo, w_all = torch.randn(2, 7, 3, generator=g), torch.randn(2, 8, 3, generator=g)
    w = [w_halo * (r + 1) for r in (0, 1)]  # the ranks' output weights
    w_gather = [w_all * (r + 1) for r in (0, 1)]
    units = [case.ranks[r]["units"] for r in (0, 1)]
    assert [u["range"] for u in units] == [(0, 4), (4, 8)]
    whole = x.clone().requires_grad_()
    windows = worker.halo_reference(whole, 1, 2, 2)
    sum((win * wr).sum() for win, wr in zip(windows, w)).backward()
    for r, u in enumerate(units):
        y, dx = u["halo"]
        torch.testing.assert_close(y, windows[r].detach(), rtol=0, atol=0)
        torch.testing.assert_close(dx, whole.grad[:, 4 * r:4 * r + 4], rtol=0, atol=1e-6)
        y, dx = u["gather"]
        torch.testing.assert_close(y, x, rtol=0, atol=0)
        torch.testing.assert_close(dx, (w_gather[0] + w_gather[1])[:, 4 * r:4 * r + 4],
                                   rtol=0, atol=1e-6)
        y, dx = u["local"]
        torch.testing.assert_close(y, x[:, 4 * r:4 * r + 4], rtol=0, atol=0)
        want = torch.zeros_like(x)
        want[:, 4 * r:4 * r + 4] = 2.0
        torch.testing.assert_close(dx, want, rtol=0, atol=0)


def test_batchnorm_moments_and_negatives_against_the_whole_tensor(case):
    """BatchNorm on each rank's frames normalizes with the whole batch's
    moments (its output, its input gradient and its running statistics are
    those of the whole tensor, each rank its frames); the negatives' indices
    a rank keeps are its frames of the global draw; ``positions`` are its
    global frame indices."""
    from tpu_speech_torch.models.spiral.conv_layers import FlaxBatchNorm1d

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 3, generator=g)
    torch.randn(2, 7, 3, generator=g), torch.randn(2, 8, 3, generator=g)  # the others' draws
    wb = torch.randn(2, 3, 8, generator=g)
    bn = FlaxBatchNorm1d(3, eps=1e-3, momentum=0.01).train()
    whole = x.transpose(1, 2).clone().requires_grad_()
    y = bn(whole)
    (y * wb).sum().backward()
    for r in (0, 1):
        u = case.ranks[r]["units"]
        y_r, dx_r, mean_r, var_r = u["bn"]
        torch.testing.assert_close(y_r, y.detach()[:, :, 4 * r:4 * r + 4], rtol=0, atol=1e-6)
        torch.testing.assert_close(dx_r, whole.grad[:, :, 4 * r:4 * r + 4], rtol=0, atol=1e-6)
        torch.testing.assert_close(mean_r, bn.running_mean, rtol=0, atol=1e-7)
        torch.testing.assert_close(var_r, bn.running_var, rtol=0, atol=1e-7)
        local, whole_idx = u["negatives"]
        assert torch.equal(local, whole_idx[:, 4 * r:4 * r + 4])
        assert torch.equal(u["positions"], torch.arange(4 * r, 4 * r + 4))


def test_the_runner_takes_jax_global_batch_and_lr_scale(case):
    """A pretrain runner at seq 2 over four ranks: two data groups (the
    loader's shards), JAX's lr rescale for two data-parallel groups
    (``_lr_scale(m, 2, 1)``), not four; a validation (each seq rank runs it
    whole on its group's rows) with the same finite loss and diagnostics on
    every rank; two updates with the same logged losses on every rank; the
    frames at the anchors halved."""
    want = _lr_scale(case.job["run_cfg"].model, 2, 1)
    for r, out in enumerate(case.ranks):
        got = out["runner"]
        assert got["lr_scale"] == want == 0.25
        assert got["data"] == (r // 2, 2) and got["shards"] == (r // 2, 2)
        assert got["iteration"] == 2 and got["loss"] == case.ranks[0]["runner"]["loss"]
        assert got["frames"]["specs"] == 112 // 2
        assert np.isfinite(got["validation"][0])
        assert got["validation"] == case.ranks[0]["runner"]["validation"]


def test_the_ranks_of_a_seq_group_step_on_the_same_audio(case):
    """Four loader threads a rank, crops shorter than the files and noise
    from a manifest: the two ranks of each data group are given the same
    device batches (waves, masks and shifts) at every step, and the two
    groups different rows."""
    groups = [[case.ranks[r]["runner"]["batches"] for r in (2 * d, 2 * d + 1)]
              for d in (0, 1)]
    for first, second in groups:
        assert len(first) == len(second) == 2
        for a, b in zip(first, second):
            assert a.keys() == b.keys()
            for k in a:
                assert (torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]), k
    assert not torch.equal(groups[0][0][0]["wavs"], groups[1][0][0]["wavs"])


def test_the_finetune_runner_refuses_the_seq_axis(tmp_path):
    """As JAX's finetune runner: seq_parallel > 1 raises before any work."""
    cfg = spiral_tiny_ctc_char()
    cfg.trainer.seq_parallel = 2
    with pytest.raises(ValueError, match="pretrain-only knob"):
        SpiralFinetuneRunner(cfg, str(tmp_path / "run"), CharTokenizer(cfg.model.labels),
                             device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_a_seq_size_that_does_not_divide_stops():
    """The frames must split into shares of the encoder's stride, and the
    ranks into seq groups: both stop with a message."""
    from tpu_speech_torch.parallel import seq

    group = seq.SeqGroup(None, 4, 1)
    with pytest.raises(ValueError, match="does not divide 72 frames"):
        seq.frame_range(72, group, multiple=8)
    assert seq.frame_range(64, group, multiple=8) == (16, 32)
    cfg = copy.deepcopy(spiral_tiny_pretrain())
    assert mesh.seq_size(None) == 1 and cfg.trainer.seq_parallel == 1
