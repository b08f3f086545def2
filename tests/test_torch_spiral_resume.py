"""PyTorch port, SPIRAL runs as the JAX CLI runs them, on the CPU: the
default ``run_spiral`` (no ``--model_type``, no ``--run_mode``) pretrains,
checkpoints every epoch and resumes; a resumed run equals a straight one bit
for bit (pretraining at accumulation 1 and 2, finetuning across
``freeze_finetune_updates``); a directory of orbax steps stops the resume;
the pretrain runner's validation against the JAX runner's on the same
weights and batch, with JAX's ``PRNGKey(0)`` negatives replayed; and
``check_collapse`` against JAX's.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.compat import torch_spiral
from tpu_speech.data.wav import write_wav
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.utils import archive as jarchive
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.configs.spiral import spiral_tiny_pretrain
from tpu_speech_torch.models.spiral import st2vec
from tpu_speech_torch.train import spiral as tspiral
from tpu_speech_torch.train.spiral import batch_to_device
from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner
from tpu_speech_torch.utils import archive
from tpu_speech_torch.utils.checkpoint import Checkpointer
from tests.test_torch_pretrain import _jax_raw_negative_indices, _student_feat_lens

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SR = 16000
VAL_ATOL = 1e-5  # validation loss and accuracy against JAX
# each check_collapse scalar against JAX on the same features; through a
# whole validation forward the scalars also carry the two packages' fp32
# forward differences (about 1e-6 relative on the features: 1.3e-6 measured
# on pred_target_sim), so there they are held to VAL_ATOL
COLLAPSE_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(root, n=6):
    """n short noise utterances (0.5-1.0 s, under the tiny configs' 1 s crop)
    under every manifest name the tiny configs read."""
    r = np.random.default_rng(0)
    lines = []
    for i in range(n):
        d = 0.5 + 0.09 * i
        path = os.path.join(root, f"u{i}.wav")
        write_wav(path, (r.standard_normal(int(SR * d)) * 0.1).astype(np.float32), SR)
        lines.append(json.dumps({"audio_filepath": path, "duration": d,
                                 "text": "ab c" if i % 2 else "hi"}) + "\n")
    for name in ("manifest.json", "librivox-train-clean-100.json", "librivox-dev-other.json"):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(lines)


def _regularised_tiny():
    """spiral_tiny_pretrain with dropout, attention dropout and layerdrop on,
    so that a resume must restore both dropout generators."""
    cfg = spiral_tiny_pretrain()
    enc = cfg.model.encoder
    cfg.model.encoder = dataclasses.replace(enc, blocks=tuple(
        dataclasses.replace(b, transformer=dataclasses.replace(
            b.transformer, dropout=0.1, attention_dropout=0.1, encoder_layerdrop=0.2))
        for b in enc.blocks))
    return cfg


def _latest(run_dir):
    ckpt = Checkpointer(os.path.join(run_dir, "ckpt"))
    return ckpt.all_steps(), ckpt.restore(ckpt.latest_step())


def _assert_same_run(a, b):
    """Two step checkpoints hold the same student, teacher, BatchNorm
    statistics, AdamW moments and counts, bit for bit."""
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["mu"].keys() == b["mu"].keys() and a["mu"]
    for k in a["mu"]:
        assert torch.equal(a["mu"][k], b["mu"][k]) and torch.equal(a["nu"][k], b["nu"][k]), k
    for k in ("count", "step", "iteration", "epoch", "host_rng"):
        assert a[k] == b[k], k
    assert torch.equal(a["rng_host"], b["rng_host"])
    assert torch.equal(a["rng_device"], b["rng_device"])


@pytest.mark.parametrize("accum", [1, 2])
def test_default_cli_pretrains_checkpoints_every_epoch_and_a_resume_equals_a_straight_run(
        tmp_path, monkeypatch, accum):
    """``run_spiral`` with no --model_type and no --run_mode pretrains (JAX's
    defaults), validates and checkpoints after every epoch, and writes
    st2vec.pt and the archive. Two epochs straight equal one epoch, then a
    second call in the same directory that resumes and runs the second: at
    accumulation 2 with 3 batches an epoch the first epoch leaves a
    micro-batch that the checkpoint carries into the second."""
    _corpus(str(tmp_path))
    monkeypatch.setitem(run_spiral.CONFIGS, "spiral_tiny_test", _regularised_tiny)
    base = ["--config_name", "spiral_tiny_test", "--data_dir", str(tmp_path), "--device", "cpu",
            "--set", "trainer.max_steps=100", "--set", "model.train_ds.num_workers=1",
            "--set", f"trainer.accumulate_grad_batches={accum}"]
    straight = run_spiral.main(base + ["--model_save_dir", str(tmp_path / "a"),
                                       "--max_epochs", "2"])
    first = run_spiral.main(base + ["--model_save_dir", str(tmp_path / "b"), "--max_epochs",
                                    "1", "--profile", "true"])
    resumed = run_spiral.main(base + ["--model_save_dir", str(tmp_path / "b"),
                                      "--max_epochs", "2"])
    per_epoch = 3 // accum
    steps_a, a = _latest(str(tmp_path / "a"))
    steps_b, b = _latest(str(tmp_path / "b"))
    assert steps_a == steps_b == ([per_epoch, 2 * per_epoch] if accum == 1 else [1, 3])
    assert straight["iteration"] == resumed["iteration"] == steps_a[-1]
    assert first["epoch"] == 1 and resumed["epoch"] == straight["epoch"] == 2
    assert len(resumed["steps"]) == len(straight["steps"]) - len(first["steps"])
    assert [m["loss"] for m in resumed["steps"]] == [m["loss"] for m in straight["steps"]][
        len(first["steps"]):]
    _assert_same_run(a, b)
    assert not a["micro"] and not b["micro"]
    if accum == 2:  # the first epoch's checkpoint carries its leftover micro-batch
        assert len(Checkpointer(str(tmp_path / "b" / "ckpt")).restore(1)["micro"]) == 1
    for res in (straight, resumed):
        assert os.path.isfile(res["state_dict"]) and res["archive"].endswith(
            "st2vec_tiny.tpu_speech")
    with open(tmp_path / "a" / "train.log") as f:
        log = [line for line in f if line.startswith("Validation")]
    assert len(log) == 2 and all("cross_utt_sim" in line for line in log)
    with open(tmp_path / "b" / "train.log") as f:
        assert [line for line in f if line.startswith("Validation")] == log
    assert os.listdir(tmp_path / "b" / "plugins" / "profile")  # --profile's trace
    assert straight["validation"]["batches"] == 3


def test_python_m_run_spiral_pretrains_then_resumes(tmp_path):
    """The module as a user runs it, ``python -m
    tpu_speech_torch.cli.run_spiral``, with no --model_type and no
    --run_mode: one epoch writes st2vec.pt, the archive and a step
    checkpoint; the same command with --max_epochs 2 resumes from it."""
    _corpus(str(tmp_path))
    run = tmp_path / "run"
    argv = [sys.executable, "-m", "tpu_speech_torch.cli.run_spiral", "--config_name",
            "spiral_tiny_test", "--data_dir", str(tmp_path), "--device", "cpu",
            "--model_save_dir", str(run), "--set", "trainer.max_steps=100",
            "--set", "model.train_ds.num_workers=1"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    outs = []
    for epochs in ("1", "2"):
        proc = subprocess.run(argv + ["--max_epochs", epochs], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
        assert os.path.isfile(run / "st2vec.pt")
        assert os.path.isfile(run / "st2vec_tiny.tpu_speech")
    assert "Resumed from iteration" not in outs[0]
    assert "Resumed from iteration 3 (epoch 1)" in outs[1]
    assert Checkpointer(str(run / "ckpt")).all_steps() == [3, 6]
    assert sorted(n for n in os.listdir(run / "ckpt") if n.startswith("step_")) == [
        "step_0000000003.pt", "step_0000000006.pt"]


def test_finetune_resume_across_the_freeze_gate_equals_a_straight_run(tmp_path):
    """Finetuning 2 epochs of 3 steps with the encoder frozen for 4 updates:
    one epoch, then a resumed call, equals the straight run bit for bit, and
    the resumed run keeps the gate (step 3 frozen, steps 4-5 not)."""
    _corpus(str(tmp_path))
    base = ["--model_type", "ctc_finetune", "--config_name", "spiral_tiny_ctc_char",
            "--manifest_dir", str(tmp_path), "--device", "cpu", "--finetune_from_scratch",
            "true", "--set", "trainer.max_steps=100", "--set", "model.train_ds.num_workers=1",
            "--set", "model.freeze_finetune_updates=4"]
    straight = run_spiral.main(base + ["--model_save_dir", str(tmp_path / "a"),
                                       "--max_epochs", "2"])
    run_spiral.main(base + ["--model_save_dir", str(tmp_path / "b"), "--max_epochs", "1"])
    resumed = run_spiral.main(base + ["--model_save_dir", str(tmp_path / "b"),
                                      "--max_epochs", "2"])
    assert [m["frozen"] for m in straight["steps"]] == [True] * 4 + [False] * 2
    assert [m["frozen"] for m in resumed["steps"]] == [True, False, False]
    _, a = _latest(str(tmp_path / "a"))
    _, b = _latest(str(tmp_path / "b"))
    _assert_same_run(a, b)
    assert a["loader_epoch"] == b["loader_epoch"] == 2
    assert resumed["archive"].endswith("ctc_tiny.tpu_speech")


def test_resume_over_orbax_steps_stops_and_names_the_flag(tmp_path):
    """A run dir whose ckpt/ holds only the JAX package's orbax step
    directories stops the resume; --resume_if_exists false trains."""
    _corpus(str(tmp_path))
    os.makedirs(tmp_path / "run" / "ckpt" / "step_0000000004")
    argv = ["--config_name", "spiral_tiny_test", "--manifest_dir", str(tmp_path), "--device",
            "cpu", "--model_save_dir", str(tmp_path / "run"), "--set", "trainer.max_steps=1",
            "--set", "model.train_ds.num_workers=1"]
    with pytest.raises(SystemExit, match="--resume_if_exists false"):
        run_spiral.main(argv)
    out = run_spiral.main(argv + ["--resume_if_exists", "false"])
    assert out["iteration"] == 1


# ---- validation against the JAX runner ---------------------------------------

@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """The port's and the JAX package's pretrain runners on one toy corpus
    and the same weights (the port's seeded init, its teacher and BatchNorm
    statistics moved off the student so that the towers differ)."""
    root = str(tmp_path_factory.mktemp("val"))
    _corpus(root)
    cfg = spiral_tiny_pretrain()
    for ds in (cfg.model.train_ds, cfg.model.validation_ds):
        ds.manifest_filepath = os.path.join(root, "manifest.json")
        ds.num_workers = 1
    port = SpiralPretrainRunner(cfg, os.path.join(root, "port"), device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        for p in port.state.model.teacher_parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        for name, b in port.state.model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.2, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)

    sys.path.insert(0, os.path.join(REPO, "cli"))
    from importlib import import_module

    from tpu_speech.train.spiral_runner import SpiralPretrainRunner as JaxRunner

    jcfg = copy.deepcopy(import_module("conf.spiral.spiral_tiny_test").cfg)
    jcfg.trainer.devices = 1
    for ds in (jcfg.model.train_ds, jcfg.model.validation_ds):
        ds.manifest_filepath = os.path.join(root, "manifest.json")
        ds.num_workers = 1
    jcfg.model.train_ds.use_native_loader = False
    jr = JaxRunner(jcfg, os.path.join(root, "jax"))
    params, bstats, teacher = torch_spiral.convert_st2vec(
        {k: v.numpy() for k, v in port.state.model.state_dict().items()})
    jr.state = jr.state.replace(params=params, batch_stats=bstats, teacher=teacher)
    return port, jr


def test_validation_matches_the_jax_runner(runners):
    """The same host draws (masks, shifts) from both runners' generators; on
    that batch, the port's no-update loss, accuracy and collapse scalars
    within 1e-5 of the JAX runner's ``validate`` function, with JAX's
    PRNGKey(0) negative indices replayed, and JAX's ``check_collapse`` on the
    port's own features within 1e-6 of the port's scalars. A whole ``validate``
    pass in each (negatives of their own generators) leaves the weights
    unchanged and writes one line of five finite numbers to train.log."""
    port, jr = runners
    before = {k: v.clone() for k, v in port.state.model.state_dict().items()}
    port.validate()
    jr.validate()  # builds its jitted validation function
    assert port.state.model.training
    for k, v in port.state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with open(os.path.join(port.log_dir, "train.log")) as f:
        line = f.read().strip().splitlines()[-1]
    values = [float(x.split(" = ")[1]) for x in line.split(" | ")]
    assert line.startswith("Validation: loss") and len(values) == 5
    assert all(np.isfinite(values))

    raw = next(iter(port.val_loader))
    batch, jbatch = port._augment(raw), jr._augment(raw)
    for k in jbatch:
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(jbatch[k]), err_msg=k)
    st = jr.state
    jloss, jacc, jdiag = jax.device_get(jr._val_fn(st.params, st.batch_stats, st.teacher,
                                                   jbatch, jax.random.PRNGKey(0)))
    enc = port.enc_cfg
    neg = st2vec.exclude_self(torch.tensor(_jax_raw_negative_indices(
        jax.random.PRNGKey(0), _student_feat_lens(raw["p_wav_lens"]),
        port.spec_len // enc.shift_unit, enc.n_negatives)))
    seen = {}
    collapse = st2vec.check_collapse

    def spy(pred, targets, feat_lens):
        seen.update(pred=pred, targets=targets, feat_lens=feat_lens)
        return collapse(pred, targets, feat_lens)

    tspiral.check_collapse = spy
    try:
        loss, acc, diag = port.validation_step(batch_to_device(batch, "cpu"), neg_idx=neg)
    finally:
        tspiral.check_collapse = collapse
    assert abs(float(loss) - float(jloss)) <= VAL_ATOL
    assert abs(float(acc) - float(jacc)) <= VAL_ATOL
    assert diag.keys() == jdiag.keys() and len(diag) == 4
    same = jst2vec.check_collapse(*(jnp.asarray(seen[k].numpy())
                                    for k in ("pred", "targets", "feat_lens")))
    for k in diag:
        assert abs(float(diag[k]) - float(jdiag[k])) <= VAL_ATOL, k
        assert abs(float(diag[k]) - float(same[k])) <= COLLAPSE_ATOL, k


@pytest.mark.parametrize("t,collapsed", [(20, False), (20, True), (100, True)])
def test_check_collapse_matches_jax(t, collapsed):
    """Each scalar within 1e-6 of JAX's, on random features and on a
    collapsed prediction (every frame the same vector), over the first
    min(feat_lens, 80) frames."""
    r = np.random.default_rng(t)
    pred = r.standard_normal((3, t, 8)).astype(np.float32)
    if collapsed:
        pred[:] = pred[0, 0]
    targets = r.standard_normal((3, t, 8)).astype(np.float32)
    lens = np.array([t, t - 5, t - 2], np.int32)
    got = st2vec.check_collapse(torch.tensor(pred), torch.tensor(targets), torch.tensor(lens))
    want = jst2vec.check_collapse(jnp.asarray(pred), jnp.asarray(targets), jnp.asarray(lens))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= COLLAPSE_ATOL, k
    if collapsed:
        assert abs(float(got["self_sim"]) - 1.0) <= COLLAPSE_ATOL
    one = st2vec.check_collapse(torch.tensor(pred[:1]), torch.tensor(targets[:1]),
                                torch.tensor(lens[:1]))
    assert "cross_utt_sim" not in one


def test_pretrain_runner_restores_a_jax_archive(tmp_path, runners):
    """A pretraining archive as the JAX runner's ``save_archive`` writes it
    (params, with the EMA teacher and the BatchNorm statistics as extra
    trees) restores into the port's runner exactly; the step and the
    optimizer stay as they were."""
    port, jr = runners
    st = jax.device_get(jr.state)
    path = str(tmp_path / "st2vec_tiny.tpu_speech")
    jarchive.save_archive(path, jarchive.config_object(json.loads(json.dumps(
        archive._to_jsonable(port.cfg)))), st.params,
        extra={"teacher": st.teacher, "batch_stats": st.batch_stats})
    cfg = copy.deepcopy(port.cfg)
    fresh = SpiralPretrainRunner(cfg, str(tmp_path / "fresh"), device="cpu", seed=3)
    fresh.restore_from_archive(path)
    got, want = fresh.state.model.state_dict(), port.state.model.state_dict()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    assert fresh.iteration == 0 and fresh.state.optimizer.count == 0
