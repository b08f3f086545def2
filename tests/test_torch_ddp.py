"""PyTorch port, data parallelism: two gloo ranks on the CPU against the JAX
package's 2-device mesh steps and the port's own one-process step on the
global batch.

One spawn (``tests/torch_ddp_worker.py``, two processes meeting at a
``file://`` store, one intra-op thread each, 120 s at most) runs every check
on its rank's contiguous slice of each global batch; the JAX side runs here on
two of the 8 virtual CPU devices (``make_mesh(n_devices=2)``, ``shard_batch``,
``replicate``, ``fsdp_shardings``), with dropout, dither and layerdrop off and
JAX's negative draws replayed, as the one-process parity tests run. FSDP runs
with a 256-element threshold on both sides (the tiny model has no leaf of
2**14), so it shards. Limits: against JAX, loss 1e-5, gradients 1e-4 x max|g|
(SGD(1) steps, whose update is the clipped gradient), AdamW parameters 2e-5;
two ranks against the port's one-process step on the global batch, 1e-6
relative loss and 1e-6 x max|p|; bf16 by the 2x bf16 rule of the step parity tests.
"""

import copy
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_speech.compat import torch_spiral
from tpu_speech.models.spiral import ctc as jctc
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.parallel import mesh as jmesh
from tpu_speech.text.tokenizers import BlankOffsetTokenizer as JaxBlankOffset
from tpu_speech.text.tokenizers import CharTokenizer as JaxCharTokenizer
from tpu_speech.train import optim as joptim
from tpu_speech.train import spiral as jspiral
from tpu_speech.train.spiral_runner import SpiralFinetuneRunner as JaxFinetuneRunner
from tpu_speech.train.spiral_runner import _lr_scale
from tpu_speech.utils.config import AdamWParams
from tpu_speech_torch.compat.jax_spiral import ctc_finetune_from_jax, st2vec_from_jax
from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char, spiral_tiny_pretrain
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, exclude_self
from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner
from tests import test_torch_finetune as tft
from tests import test_torch_pretrain as tpt
from tests import torch_ddp_worker as worker
from tests.test_torch_runner import _corpus
from tests.test_torch_spiral_ctc import jax_ctc_model

jax.config.update("jax_default_matmul_precision", "highest")

SR = 16000
CLIP = 4.0  # below the tiny step's gradient norm (5.11): the clip is active
FSDP_MIN = 256
SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global(*batches):
    """Host batches of 2 -> one global batch, the first one's shifts."""
    return {k: np.concatenate([b[k] for b in batches]) if np.ndim(batches[0][k])
            else batches[0][k] for k in batches[0]}


def _negatives(key, batch, n):
    """JAX's negative indices of ``sample_negatives`` on the global batch."""
    lens = tpt._student_feat_lens(batch["p_wav_lens"])
    return exclude_self(torch.tensor(tpt._jax_raw_negative_indices(key, lens, 14, n)))


def _st2vec_trees(sd):
    return torch_spiral.convert_st2vec({k: v.numpy() for k, v in sd.items()})


def _ctc_tree(sd):
    (enc, _, _), (dec, _) = torch_spiral.convert_ctc_finetune({k: v.numpy() for k, v in sd.items()})
    return {"encoder": enc, "decoder": dec}


def _start(root: str):
    """Start the two ranks of ``torch_ddp_worker.run`` (``_join`` waits)."""
    import torch.multiprocessing as mp

    return mp.start_processes(worker.run, args=(root,), nprocs=2, join=False,
                              start_method="spawn"), time.monotonic()


def _join(started) -> float:
    """Wait for the ranks; fails past SPAWN_TIMEOUT from their start."""
    ctx, t0 = started
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > SPAWN_TIMEOUT:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two ranks did not finish within {SPAWN_TIMEOUT} s")
    return time.monotonic() - t0


def _toy_manifest(root, n=8):
    r = np.random.default_rng(0)
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        for i in range(n):
            wav = os.path.join(root, f"p{i}.wav")
            write_wav(wav, (r.standard_normal(int(SR * (0.6 + 0.05 * i))) * 0.1)
                      .astype(np.float32), SR)
            f.write(json.dumps({"audio_filepath": wav, "duration": 0.6 + 0.05 * i,
                                "text": "a"}) + "\n")
    return path


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The job (tiny configs, JAX-initialized weights, global batches of 4)
    and the two ranks' results; the JAX mesh steps run here while the ranks
    run."""
    root = str(tmp_path_factory.mktemp("ddp"))
    mesh = jmesh.make_mesh(n_devices=2)
    job = {"root": root, "world": 2, "clip": CLIP, "fsdp_min_size": FSDP_MIN}

    # ---- pretraining: SGD(1) with the clip, AdamW with accumulation, FSDP
    cfg, jcfg = tpt._tiny()
    jmodel = jst2vec.ST2VecEncoder(jcfg)
    init = jspiral.init_spiral_state(jmodel, jax.random.PRNGKey(0), (2, 112, 16),
                                     optax.sgd(1.0))
    params, bstats, teacher = (jax.tree.map(np.asarray, t)
                               for t in (init.params, init.batch_stats, init.teacher))
    batch = _global(tpt._batch(jcfg, 0), tpt._batch(jcfg, 5))
    key = jax.random.PRNGKey(7)
    job.update(pre_cfg=cfg, pre_sd=st2vec_from_jax(params, bstats, teacher), pre_batch=batch,
               pre_neg=_negatives(jax.random.fold_in(key, 3), batch, jcfg.n_negatives))
    micro = [_global(tpt._batch(jcfg, 3), tpt._batch(jcfg, 8)),
             _global(tpt._batch(jcfg, 4), tpt._batch(jcfg, 9))]
    stacked = {k: np.stack([mb[k] for mb in micro]) for k in micro[0]}
    key2 = jax.random.PRNGKey(11)
    job.update(pre_micro=stacked, pre_micro_neg=[
        _negatives(jax.random.fold_in(jax.random.fold_in(key2, i), 3), mb, jcfg.n_negatives)
        for i, mb in enumerate(micro)])

    # dropout and layerdrop on: three updates, negatives drawn by each rank
    drop_cfg, _ = tpt._tiny(attention_dropout=0.1, layerdrop=0.5)
    job.update(drop_cfg=drop_cfg, drop_steps=[
        (_global(tpt._batch(jcfg, 20 + i), tpt._batch(jcfg, 30 + i)), None) for i in range(3)])

    # ---- finetuning: AdamW across the freeze gate (step 0 frozen)
    fcfg, fjmodel, fjcfg = tft._tiny()
    fparams = jax.tree.map(np.asarray, jax.jit(fjmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)["params"])
    ocfg = AdamWParams(lr=1e-3, eps=1e-3, betas=(0.9, 0.98), weight_decay=0.1, sched=None)
    ft_batches = [_global(tft._batch(10 + i), tft._batch(20 + i)) for i in range(2)]
    job.update(ft_cfg=fcfg, ft_sd=ctc_finetune_from_jax(fparams, {}), ft_optim=ocfg,
               ft_batches=ft_batches)

    # ---- evaluation: the CTC runner on the corpus of the runner tests
    eval_cfg = spiral_tiny_ctc_char()
    ejmodel = jax_ctc_model(eval_cfg)
    eparams = jax.tree.map(np.asarray, jax.jit(ejmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)["params"])
    os.makedirs(os.path.join(root, "corpus"))
    manifest, _ = _corpus(os.path.join(root, "corpus"))
    job.update(eval_cfg=eval_cfg, eval_sd=ctc_finetune_from_jax(eparams, {}),
               eval_manifest=manifest)

    # ---- a pretrain runner's step checkpoints, and its bf16 validation
    run_cfg = spiral_tiny_pretrain()
    run_cfg.model.train_ds.manifest_filepath = _toy_manifest(root)
    run_cfg.model.train_ds.num_workers = 1
    val_cfg = copy.deepcopy(run_cfg)
    val_cfg.model.validation_ds.manifest_filepath = run_cfg.model.train_ds.manifest_filepath
    val_cfg.model.validation_ds.num_workers = 1
    val_cfg.model.precision = "bf16"
    run_cfg.model.validation_ds = None
    run_cfg.model.expected_gpu_num = 8
    job.update(run_cfg=run_cfg, val_cfg=val_cfg)

    job["checks"] = list(worker.CHECKS)
    torch.save(job, os.path.join(root, "job.pt"))
    started = _start(root)

    # ---- the JAX side, while the ranks run
    jax_out = {}

    def jstate(tx, shardings=None):
        st = jspiral.SpiralTrainState(jnp.zeros((), jnp.int32), params, bstats, teacher,
                                      tx.init(params))
        if shardings is None:
            return jmesh.replicate(mesh, st)
        return jax.tree.map(jax.device_put, st, shardings)

    sgd = optax.sgd(1.0)
    new, m = jspiral.make_pretrain_step(jmodel, jcfg, sgd, grad_clip=CLIP, mesh=mesh)(
        jstate(sgd), jmesh.shard_batch(mesh, batch), key)
    jax_out["pre_sgd"] = jax.device_get((new.params, new.batch_stats, m))
    host = jspiral.SpiralTrainState(jnp.zeros((), jnp.int32), params, bstats, teacher,
                                    sgd.init(params))
    shardings = jmesh.fsdp_shardings(mesh, host, min_size=FSDP_MIN)
    new, m = jspiral.make_pretrain_step(jmodel, jcfg, sgd, grad_clip=CLIP, mesh=mesh,
                                        state_shardings=shardings)(
        jstate(sgd, shardings), jmesh.shard_batch(mesh, batch), key)
    jax_out["pre_sgd_fsdp"] = jax.device_get((new.params, new.batch_stats, m))
    jax_out["fsdp_specs"] = shardings.params

    tx = joptim.make_optimizer(cfg.model.optim, 100)
    new, m = jspiral.make_pretrain_step(jmodel, jcfg, tx, grad_clip=CLIP, accum_steps=2,
                                        mesh=mesh)(
        jstate(tx), jmesh.shard_microbatches(mesh, stacked), key2)
    jax_out["pre_adamw_accum2"] = jax.device_get((new.params, new.batch_stats, new.teacher, m))

    tx = joptim.make_optimizer(ocfg, 100)
    st = jmesh.replicate(mesh, jctc.CTCTrainState(jnp.zeros((), jnp.int32), fparams, {},
                                                  tx.init(fparams)))
    step = jctc.make_finetune_step(fjmodel, fjcfg, tx, freeze_finetune_updates=1, mesh=mesh)
    losses = []
    for i, b in enumerate(ft_batches):
        st, m = step(st, jmesh.shard_batch(mesh, b), jax.random.PRNGKey(i), iteration=i)
        losses.append(float(m["loss"]))
    jax_out["ft_adamw"] = (jax.device_get(st.params), losses)

    ejcfg = tpt.jax_encoder_cfg(eval_cfg.model.encoder)

    @jax.jit
    def infer(p, bs, wavs, lens):  # the JAX runner's _infer_fn
        specs, spec_lens = jst2vec.wav_to_spec(ejcfg, wavs, lens)
        return ejmodel.apply({"params": p}, specs, spec_lens, train=False)

    tokenizer = JaxCharTokenizer(eval_cfg.model.labels)
    if eval_cfg.model.decoder.blank_pos == "vocab_first":  # as the JAX runner wraps it
        tokenizer = JaxBlankOffset(tokenizer)
    jself = types.SimpleNamespace(
        cfg=eval_cfg, tokenizer=tokenizer, max_samples=SR, _infer_fn=lambda: infer,
        model=ejmodel,
        state=types.SimpleNamespace(params=eparams, batch_stats={}), primary=True,
        log_dir=os.path.join(root, "jax_eval"))
    os.makedirs(jself.log_dir)
    jax_out["evaluate"] = JaxFinetuneRunner.evaluate(jself, manifest)

    seconds = _join(started)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    return types.SimpleNamespace(job=job, jax=jax_out, ranks=ranks, seconds=seconds,
                                 params=params, fparams=fparams)


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
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=rel * scale, msg=k)


def test_the_ranks_finish_within_their_timeout(case):
    assert case.seconds < SPAWN_TIMEOUT


@pytest.mark.parametrize("name", ["pre_sgd", "pre_sgd_fsdp"])
def test_pretrain_step_matches_the_jax_mesh_step(case, name):
    """The SGD(1) step with the clip, two ranks (DDP, and FSDP against JAX's
    ``fsdp_shardings`` step): the global loss and accuracy, the clipped
    gradients and the BatchNorm statistics of the global batch."""
    want_params, want_stats, jm = case.jax[name]
    r0 = case.ranks[0][name]
    np.testing.assert_allclose(r0["loss"][0], float(jm["loss"]), rtol=1e-5)
    assert r0["acc"][0] == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    got_params, got_stats, _ = _st2vec_trees(r0["sd"])
    tpt._assert_grads_close(tpt._sgd_grads(case.params, got_params),
                            tpt._sgd_grads(case.params, want_params))
    got, want = dict(tpt._leaves(got_stats)), dict(tpt._leaves(want_stats))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg="/".join(k))


def test_the_clip_takes_the_global_norm(case):
    """The clip is active and its norm is the whole gradient's: the SGD(1)
    update's norm is the clip value on both ranks, for DDP and FSDP, as for
    JAX (and the gradients match JAX's, above)."""
    for name in ("pre_sgd", "pre_sgd_fsdp"):
        got_params = _st2vec_trees(case.ranks[1][name]["sd"])[0]
        delta = tpt._sgd_grads(case.params, got_params)
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in delta.values()))
        assert norm == pytest.approx(CLIP, rel=1e-4), name
    want = tpt._sgd_grads(case.params, case.jax["pre_sgd"][0])
    assert np.sqrt(sum(float((g ** 2).sum()) for g in want.values())) == pytest.approx(
        CLIP, rel=1e-4)


@pytest.mark.parametrize("name", ["pre_sgd", "pre_adamw_accum2", "ft_adamw"])
def test_two_ranks_equal_the_one_process_global_batch_step(case, name):
    one = _one_process(case, name)
    for r in case.ranks:
        np.testing.assert_allclose(r[name]["loss"], one["loss"], rtol=1e-6)
        _assert_params_close(r[name]["sd"], one["sd"])


@pytest.mark.parametrize("name", ["pre_sgd", "pre_sgd_fsdp", "pre_adamw_accum2", "ft_adamw",
                                  "ft_adamw_fsdp", "pre_dropout"])
def test_the_ranks_hold_equal_weights_bit_for_bit(case, name):
    a, b = (r[name]["sd"] for r in case.ranks)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_batchnorm_moments_are_the_global_batch(case):
    """The predictor's BatchNorm statistics after the step equal the
    one-process step's on the global batch, and differ from a step on rank
    0's half alone (the moments are not local)."""
    one = _one_process(case, "pre_sgd")
    half = dict(case.job, pre_batch={k: v[:2] if np.ndim(v) else v
                                     for k, v in case.job["pre_batch"].items()},
                pre_neg=case.job["pre_neg"][:2])
    local = worker.CHECKS["pre_sgd"](half, 0, 1)
    keys = [k for k in one["sd"] if "running_" in k]
    assert keys
    for k in keys:
        torch.testing.assert_close(case.ranks[0]["pre_sgd"]["sd"][k], one["sd"][k], rtol=0,
                                   atol=1e-6)
    assert any((local["sd"][k] - one["sd"][k]).abs().max() > 1e-4 for k in keys)


def test_pretrain_accum2_adamw_matches_the_jax_mesh_step(case):
    want = case.jax["pre_adamw_accum2"]
    r0 = case.ranks[0]["pre_adamw_accum2"]
    np.testing.assert_allclose(r0["loss"][0], float(want[3]["loss"]), rtol=1e-5)
    assert r0["layers"] == [(4, 4)]
    for got, w in zip(_st2vec_trees(r0["sd"]), want[:3]):
        got, w = dict(tpt._leaves(got)), dict(tpt._leaves(w))
        assert got.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(got[k], w[k], atol=2e-5, rtol=0, err_msg="/".join(k))


@pytest.mark.parametrize("name", ["ft_adamw", "ft_adamw_fsdp"])
def test_finetune_across_the_freeze_gate_matches_the_jax_mesh_step(case, name):
    """Step 0 frozen, step 1 not: the global CTC losses and then every
    parameter, DDP and FSDP."""
    want, losses = case.jax["ft_adamw"]
    r0 = case.ranks[0][name]
    np.testing.assert_allclose(r0["loss"], losses, rtol=1e-5)
    got, want = dict(tpt._leaves(_ctc_tree(r0["sd"]))), dict(tpt._leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=0, err_msg="/".join(k))


def test_fsdp_shards_what_jax_shards_and_equals_ddp(case):
    """FSDP sharded the leaves its rule picks (some, at this threshold) and
    left the rest replicated; its step equals the DDP step."""
    r0 = case.ranks[0]
    assert r0["pre_sgd_fsdp"]["sharded"] and not r0["pre_sgd"]["sharded"]
    n_jax = sum(1 for s in jax.tree.leaves(case.jax["fsdp_specs"],
                                           is_leaf=lambda x: hasattr(x, "spec"))
                if any(p is not None for p in s.spec))
    assert 0 < n_jax
    np.testing.assert_allclose(r0["pre_sgd_fsdp"]["loss"], r0["pre_sgd"]["loss"], rtol=1e-6)
    _assert_params_close(r0["pre_sgd_fsdp"]["sd"], r0["pre_sgd"]["sd"])
    assert 0 < r0["pre_sgd_fsdp"]["bytes"][0] < r0["pre_sgd"]["bytes"][0]


@pytest.mark.parametrize("name", ["pre_sgd_bf16", "pre_sgd_fsdp_bf16"])
def test_bf16_two_ranks_within_the_2x_rule(case, name):
    """bf16 over two ranks (cast copies under DDP; FSDP's bf16 gathers)
    against the fp32 one-process step: within twice the one-process bf16
    step's error (the 2x bf16 rule), loss and each large gradient leaf."""
    fp32, bf16 = _one_process(case, "pre_sgd"), _one_process(case, "pre_sgd_bf16")
    got = case.ranks[0][name]
    l32, l1, l2 = fp32["loss"][0], bf16["loss"][0], got["loss"][0]
    assert abs(l2 - l32) <= 2 * abs(l1 - l32) + 5e-3 * abs(l32), (l2, l1, l32)
    g32 = {k: fp32["sd"][k] - case.job["pre_sd"][k] for k in fp32["sd"]
           if fp32["sd"][k].is_floating_point() and "running" not in k}
    g_max = max(float(g.abs().max()) for g in g32.values())
    for k, g in g32.items():
        if float(g.abs().max()) < 1e-2 * g_max:
            continue
        e2 = float((got["sd"][k] - case.job["pre_sd"][k] - g).norm())
        e1 = float((bf16["sd"][k] - case.job["pre_sd"][k] - g).norm())
        assert e2 <= 2 * e1 + 1e-2 * float(g.norm()), (k, e2, e1)


def test_layerdrop_agrees_across_ranks_with_dropout_on(case):
    """Three AdamW updates with attention dropout 0.1 and layerdrop 0.5: both
    ranks skip the same layers (the host generator is seeded alike) and end
    with equal weights; some layer was skipped."""
    a, b = (r["pre_dropout"] for r in case.ranks)
    assert a["layers"] == b["layers"]
    assert any(t < 2 or s < 2 for t, s in a["layers"])
    assert all(np.isfinite(a["loss"]))


def test_device_streams_differ_across_ranks(case):
    """The host generator draws alike on every rank; the device generator
    differs, and rank 0's is the one-process run's."""
    from tpu_speech_torch.models.spiral.dropout import DropoutRng

    a, b = (r["streams"] for r in case.ranks)
    assert a["host"] == b["host"]
    assert not torch.equal(a["device"], b["device"])
    assert torch.equal(a["device"], torch.rand(8, generator=DropoutRng.seeded(3, "cpu").device))
    assert (a["row0"], b["row0"]) == (0, 2)


def test_evaluation_over_two_ranks_equals_one_process_and_jax(case):
    """WER, CER, n and SER of the two ranks (each decoding entries[r::2])
    equal one process's and the JAX single-process evaluate's; the ranks'
    hypotheses interleave into the one process's; each rank writes its own
    logits files."""
    one = _one_process(case, "evaluate")
    ref = case.jax["evaluate"]
    for r in case.ranks:
        got = r["evaluate"]
        for k in ("wer", "cer", "n", "ser"):
            assert got[k] == pytest.approx(one[k], abs=0) and got[k] == pytest.approx(ref[k],
                                                                                    abs=1e-12)
    a, b = (r["evaluate"]["hyps"] for r in case.ranks)
    merged = [h for pair in zip(a, b + [None]) for h in pair if h is not None]
    assert merged == one["hyps"]
    logits = sorted(os.listdir(os.path.join(case.job["root"], "eval", "logits")))
    assert logits == ["logits_r0_2.npy", "logits_r0_3.npy", "logits_r1_2.npy"]


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_a_checkpoint_of_two_ranks_resumes_in_one_process(case, kind):
    """Rank 0 wrote the whole state (gathered under FSDP) with each rank's
    generators under ``ranks``; DDP and FSDP wrote the same weights; one
    process resumes from it at the next epoch with the two ranks' weights.
    The lr rescale counted the ranks (JAX's ``_lr_scale``)."""
    out = case.ranks[0]["ckpt_" + kind]
    assert out["lr_scale"] == _lr_scale(case.job["run_cfg"].model, 2, 1) == 0.25
    st = torch.load(os.path.join(out["dir"], "ckpt", "step_0000000002.pt"), weights_only=False)
    assert len(st["ranks"]) == 2 and st["iteration"] == 2
    _assert_params_close(st["model"], out["sd"], rel=0)
    other = case.ranks[0]["ckpt_" + ("fsdp" if kind == "ddp" else "ddp")]
    _assert_params_close(out["sd"], other["sd"])
    cfg = copy.deepcopy(case.job["run_cfg"])
    runner = SpiralPretrainRunner(cfg, out["dir"], device="cpu")
    assert runner.resume_if_exists() and (runner.iteration, runner.epoch) == (2, 1)
    _assert_params_close(runner.state.model.state_dict(), out["sd"], rel=0)
    single = torch.load(out["state_dict"], weights_only=True)
    assert single.keys() == out["sd"].keys()
    runner.train_epoch(2, max_steps=3)
    assert runner.iteration == 3


def test_the_all_reduce_moves_every_replicated_gradient(case):
    """DDP sums every student gradient (float32 bytes); the one-process run
    makes no collective."""
    model = ST2VecEncoder(case.job["pre_cfg"].model.encoder, pretraining=True)
    n = sum(p.numel() for p in model.student_parameters())
    assert case.ranks[0]["pre_sgd"]["bytes"] == [4 * n]
    assert _one_process(case, "pre_sgd")["bytes"] == [0]


def test_fsdp_bf16_evaluates_in_float32_on_uneven_shards(case):
    """A finetune runner sharded for bf16 training evaluates the corpus, where
    rank 0 decodes one batch more than rank 1: no rank waits on a collective
    the other never joins, and the WER, CER, n and SER are one float32
    process's (the forwards run on the whole weights, not FSDP's bf16
    gathers)."""
    one = _one_process(case, "evaluate")
    assert [len(r["evaluate_fsdp_bf16"]["hyps"]) for r in case.ranks] == [3, 2]
    for r in case.ranks:
        got = r["evaluate_fsdp_bf16"]
        for k in ("wer", "cer", "n", "ser"):
            assert got[k] == pytest.approx(one[k], abs=0), k
        assert got["hyps"] == one["hyps"][got["rank"]::2]


def test_fsdp_bf16_pretrain_validation_equals_ddp(case):
    """The bf16 pretrain runner's validation over two ranks: sharded (FSDP)
    it equals the replicated run (DDP, float32 on the masters) in the loss,
    accuracy and collapse diagnostics, and the ranks agree."""
    for r in case.ranks:
        ddp, fsdp = r["validate_bf16"], r["validate_fsdp_bf16"]
        assert fsdp["sharded"] and not ddp["sharded"]
        assert ddp["batches"] == fsdp["batches"] == 2
        for k in ("loss", "accuracy", "self_sim", "target_self_sim", "pred_target_sim",
                  "cross_utt_sim"):
            np.testing.assert_allclose(fsdp[k], ddp[k], rtol=1e-6, atol=1e-7, err_msg=k)
    a, b = (r["validate_fsdp_bf16"] for r in case.ranks)
    assert a == b
