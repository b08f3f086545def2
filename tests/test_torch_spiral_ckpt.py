"""PyTorch port, SPIRAL weight files against the JAX package on the CPU: weight
surgery (``utils/surgery.py``), the msgpack codec against flax's
serialization, the flax-tree converters in both directions, ``.tpu_speech``
archives in both directions (served by ``run_spiral --run_mode test
--init_archive``), ``--use_chkpt_hparams`` and ``--load_model_skip_var``,
and the CLI's flag surface against ``cli/run_spiral.py::build_parser``.

Tiny configs and seeded numpy inputs; the JAX model runs on the CPU's XLA at
full fp32 matmul precision.
"""

import dataclasses
import json
import os
import sys
import tarfile

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from tpu_speech.compat import torch_spiral
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.utils import archive as jarchive
from tpu_speech.utils import surgery as jsurgery
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.compat import jax_spiral
from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char, spiral_tiny_pretrain
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder
from tpu_speech_torch.text.tokenizers import CharTokenizer
from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner, build_model
from tpu_speech_torch.utils import archive, msgpack, surgery
from tpu_speech_torch.utils.exp_manager import ExpManager
from tests.test_torch_runner import _corpus, _padded
from tests.test_torch_spiral_ctc import jax_ctc_model, jax_encoder_cfg

jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# serving against JAX (ROADMAP "Parity so far"): x max(1, max|JAX|)
SERVE_RTOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the tiny models' ops are small, and
    under the suite's six workers a team of threads per op spins on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], pre + (k,))
    else:
        yield "/".join(pre), tree


def _exact(x):
    """(dtype name, array) of a leaf; bfloat16 (a torch tensor or flax's
    numpy extension dtype) as its exact float32 values."""
    if torch.is_tensor(x):
        name = "bfloat16" if x.dtype == torch.bfloat16 else str(x.dtype).split(".")[-1]
        return name, x.float().numpy() if name == "bfloat16" else x.numpy()
    x = np.asarray(x)
    return x.dtype.name, x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:8]
    for k in want:
        (da, a), (db, b) = _exact(got[k]), _exact(want[k])
        assert da == db, (k, da, db)
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---- surgery ---------------------------------------------------------------

def _tree(scale=1.0, extra=False, reshaped=False):
    t = {"encoder": {"conv": {"kernel": np.full((3, 4), scale, np.float32),
                              "bias": np.full((4,), scale, np.float32)},
                     "norm": {"scale": np.full((4,), scale, np.float32)}},
         "decoder": {"proj": {"kernel": np.full((4, 7), scale, np.float32)}}}
    if extra:
        t["quantizer"] = {"codebook": np.zeros((2, 2), np.float32)}
    if reshaped:
        t["decoder"]["proj"]["kernel"] = np.full((4, 9), scale, np.float32)
    return t


def _surgery_case(case):
    """(target, source, partial, skip) of ``tests/test_checkpoint_surgery.py``'s
    cases (:40-88)."""
    if case == "strict":
        return _tree(1.0), _tree(2.0), False, ()
    if case == "strict_missing":
        src = _tree(2.0)
        del src["decoder"]
        return _tree(1.0), src, False, ()
    if case == "strict_mismatch":
        return _tree(1.0), _tree(2.0, reshaped=True), False, ()
    if case == "partial":
        src = _tree(2.0, extra=True, reshaped=True)
        del src["encoder"]["norm"]
        return _tree(1.0), src, True, ()
    return _tree(1.0), _tree(2.0), False, surgery.parse_skip_vars("decoder, norm")


@pytest.mark.parametrize("case", ["strict", "strict_missing", "strict_mismatch", "partial",
                                  "skip"])
def test_merge_params_matches_jax(case):
    """The same loaded, missing, mismatched, skipped and unexpected lists and
    merged leaves, or the same strict-load error."""
    target, source, partial, skip = _surgery_case(case)
    assert surgery.parse_skip_vars(" decoder,, norm ") == jsurgery.parse_skip_vars(
        " decoder,, norm ")
    try:
        want, jrep = jsurgery.merge_params(target, source, partial=partial, skip=skip)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            surgery.merge_params(target, source, partial=partial, skip=skip)
        assert str(got.value) == str(e)
        return
    got, rep = surgery.merge_params(target, source, partial=partial, skip=skip)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.summary() == jrep.summary()
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    flat = surgery.flatten_paths(source)
    assert flat.keys() == jsurgery.flatten_paths(source).keys()
    _assert_trees_equal(surgery.unflatten_paths(flat), source)


# ---- the msgpack codec -------------------------------------------------------

def _flax_tree(rng):
    return {
        "params": {"dense": {"kernel": rng.standard_normal((5, 7)).astype(np.float32),
                             "bias": np.zeros((7,), np.float32)},
                   "ids": np.arange(300, dtype=np.int32).reshape(3, 100),
                   "half": np.asarray(jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)),
                   "empty": np.zeros((0, 3), np.float32)},
        "step": np.int32(7), "scale": np.float32(0.25), "flag": True, "none": None,
        "count": 70000, "neg": -129, "lr": 1.5e-3, "name": "x" * 40,
        "big": rng.standard_normal(20000).astype(np.float32),
    }


def test_codec_reads_flax_and_flax_reads_the_codec():
    """The port decodes ``flax.serialization.to_bytes`` exactly (bfloat16 into
    ``torch.bfloat16``, numpy scalars as numpy scalars); flax's
    ``msgpack_restore`` reads the port's encoding exactly; the bytes are the
    same."""
    tree = _flax_tree(np.random.default_rng(0))
    data = flax.serialization.to_bytes(tree)
    got = msgpack.unpackb(data)
    assert got["params"]["half"].dtype == torch.bfloat16
    assert isinstance(got["step"], np.int32) and got["step"] == 7
    assert isinstance(got["scale"], np.float32) and got["scale"] == np.float32(0.25)
    assert got["flag"] is True and got["none"] is None and got["name"] == "x" * 40
    assert (got["count"], got["neg"], got["lr"]) == (70000, -129, 1.5e-3)
    _assert_trees_equal(got["params"], tree["params"])
    np.testing.assert_array_equal(got["big"], tree["big"])
    again = msgpack.packb(got)
    assert again == data
    back = flax.serialization.msgpack_restore(again)
    assert back["params"]["half"].dtype.name == "bfloat16"
    _assert_trees_equal(back["params"], tree["params"])
    assert back["step"] == 7 and back["step"].dtype == np.int32


def test_codec_refuses_what_it_does_not_handle():
    with pytest.raises(ValueError, match="ext code 2"):
        msgpack.unpackb(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {}}}
    with pytest.raises(ValueError, match="chunked array leaves"):
        msgpack.unpackb(msgpack.packb(chunked))
    with pytest.raises(ValueError, match="chunked leaves"):
        msgpack.packb({"w": torch.empty(2 ** 28 + 1)})
    with pytest.raises(ValueError, match="not a str"):
        msgpack.packb({1: 2})


# ---- converters --------------------------------------------------------------

def _port_models():
    pre = ST2VecEncoder(spiral_tiny_pretrain().model.encoder, pretraining=True)
    pre.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # a teacher apart from the student, BN statistics moved
        for p in pre.teacher_parameters():
            p.add_(0.01)
        for name, b in pre.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                b.add_(0.1)
    ctc = build_model(spiral_tiny_ctc_char(), 28)
    ctc.init_weights(torch.Generator().manual_seed(1))
    return pre, ctc


def test_converters_are_exact_both_ways():
    """``*_to_jax`` gives what the JAX package's ``convert_*`` gives, and
    ``*_from_jax`` after it gives the state_dict back bit for bit (BatchNorm's
    ``num_batches_tracked``, which flax lacks, comes back 0); ``*_to_jax``
    after ``*_from_jax`` gives the trees back."""
    pre, ctc = _port_models()
    sd = pre.state_dict()
    trees = jax_spiral.st2vec_to_jax(sd)
    for got, want in zip(trees, torch_spiral.convert_st2vec(
            {k: v.numpy() for k, v in sd.items()})):
        _assert_trees_equal(got, want)
    back = jax_spiral.st2vec_from_jax(*trees)
    assert back.keys() == sd.keys()
    for k in sd:
        want = torch.zeros_like(sd[k]) if k.endswith("num_batches_tracked") else sd[k]
        assert torch.equal(back[k], want), k
    for got, want in zip(jax_spiral.st2vec_to_jax(back), trees):
        _assert_trees_equal(got, want)

    sd = ctc.state_dict()
    params, bstats = jax_spiral.ctc_finetune_to_jax(sd)
    (enc, enc_bs, _), (dec, dec_bs) = torch_spiral.convert_ctc_finetune(
        {k: v.numpy() for k, v in sd.items()})
    _assert_trees_equal(params, {"encoder": enc, "decoder": dec})
    want_bs = {k: v for k, v in (("encoder", enc_bs), ("decoder", dec_bs)) if v}
    _assert_trees_equal(bstats, want_bs)
    back = jax_spiral.ctc_finetune_from_jax(params, bstats)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    _assert_trees_equal(jax_spiral.ctc_finetune_to_jax(back)[0], params)
    with pytest.raises(ValueError, match="unconsumed"):
        jax_spiral.ctc_finetune_to_jax({**sd, "decoder.stray.weight": torch.zeros(2)})


# ---- archives ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ctc():
    """The JAX tiny CTC model with random weights, its run config rebuilt by
    the JAX package's ``config_object`` from the port's config, and its
    jitted inference (the JAX runner's ``_infer_fn``)."""
    cfg = spiral_tiny_ctc_char()
    jcfg = jarchive.config_object(json.loads(json.dumps(archive._to_jsonable(cfg))))
    jmodel = jax_ctc_model(cfg)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    enc = jax_encoder_cfg(cfg.model.encoder)

    def infer(params, wavs, lens):
        specs, spec_lens = jst2vec.wav_to_spec(enc, jnp.asarray(wavs), jnp.asarray(lens))
        return jmodel.apply({"params": params}, specs, spec_lens, train=False)

    return jcfg, params, jax.jit(infer)


def _test_mode(tmp_path, name, manifest, *extra):
    run_dir = str(tmp_path / name)
    results = run_spiral.main([
        "--model_type", "ctc_finetune", "--run_mode", "test", "--config_name",
        "spiral_tiny_ctc_char", "--test_manifest", manifest, "--model_save_dir", run_dir,
        "--save_logits", "true", "--device", "cpu", *extra])
    # test_ds.batch_size 2: batches of 2, 2, 1
    logits = np.concatenate([np.load(os.path.join(run_dir, "logits", f"logits_{n}.npy"))
                             for n in (2, 4, 5)])
    return results, logits


def _serves_like(got, want):
    want = np.asarray(want)
    tol = SERVE_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_jax_archive_serves_in_the_port(tmp_path, jax_ctc):
    """An archive JAX's ``save_archive`` writes (one leaf bfloat16-exact: the
    decoder bias rounded to bf16 and stored as bf16) served through
    ``--run_mode test --init_archive``: the log-probs of JAX's inference on
    the same batches."""
    jcfg, params, infer = jax_ctc
    params = jax.tree.map(np.copy, params)
    bias = params["decoder"]["decoder_proj"]["bias"]
    stored = dict(params, decoder=dict(params["decoder"], decoder_proj=dict(
        params["decoder"]["decoder_proj"], bias=np.asarray(jnp.asarray(bias, jnp.bfloat16)))))
    params["decoder"]["decoder_proj"]["bias"] = np.asarray(
        jnp.asarray(bias, jnp.bfloat16).astype(jnp.float32))
    path = str(tmp_path / "jax.tpu_speech")
    jarchive.save_archive(path, jcfg, stored, extra={"batch_stats": {}})
    manifest, entries = _corpus(str(tmp_path))
    results, got = _test_mode(tmp_path, "run", manifest, "--init_archive", path)
    assert results["n"] == len(entries)
    want, _ = infer(params, *_padded(entries))
    _serves_like(got, want)


def test_port_archive_reads_in_jax(tmp_path, jax_ctc):
    """The port's archive of a runner's model: JAX's ``load_archive`` and
    ``config_object`` read it back to the same log-probs (JAX's inference on
    the archive's trees against the port's own) and the same config (JAX's
    classes, and the same tagged JSON)."""
    _, params, infer = jax_ctc
    cfg = spiral_tiny_ctc_char()
    runner = SpiralFinetuneRunner(cfg, str(tmp_path / "run"), CharTokenizer(cfg.model.labels),
                                  device="cpu")
    runner.load_state_dict(jax_spiral.ctc_finetune_from_jax(params, {}))
    path = runner.save_archive()
    assert os.path.basename(path) == "ctc_tiny.tpu_speech"
    with tarfile.open(path) as tar:
        assert sorted(tar.getnames()) == ["batch_stats.msgpack", "config.json",
                                          "params.msgpack"]
    config, jparams, extra = jarchive.load_archive(path)
    assert extra == {"batch_stats": {}}
    restored = jarchive.config_object(config)
    assert type(restored).__module__ == "tpu_speech.utils.config"
    assert type(restored.model.encoder).__module__ == "tpu_speech.models.spiral.st2vec"
    assert jarchive._to_jsonable(restored) == config == archive._to_jsonable(cfg)
    manifest, entries = _corpus(str(tmp_path))
    wavs, lens = _padded(entries)
    want, _ = infer(jparams, wavs, lens)
    got, _ = runner.infer(wavs, lens)
    _serves_like(got.numpy(), want)


def test_archive_configs_rebuild_in_both_packages():
    """The tagged config JSON of the three configs the archives carry is the
    JAX package's own; each package's ``config_object`` rebuilds its own
    classes from it, and the port imports only its own modules."""
    sys.path.insert(0, os.path.join(REPO, "cli"))
    import copy
    from importlib import import_module

    for jname, port in (("spiral_tiny_test", "spiral_tiny_test"),
                        ("spiral_base_pretrain_ls960", "spiral_base_pretrain_ls960"),
                        ("spiral_base_finetune_ls100_char", "spiral_base_finetune_ls100_char")):
        jcfg = copy.deepcopy(import_module(f"conf.spiral.{jname}").cfg)
        blob = json.loads(json.dumps(archive._to_jsonable(run_spiral.CONFIGS[port]())))
        assert blob == json.loads(json.dumps(jarchive._to_jsonable(jcfg))), jname
        rebuilt = archive.config_object(blob)
        assert type(rebuilt).__module__ == "tpu_speech_torch.utils.config"
        assert rebuilt.model.encoder == run_spiral.CONFIGS[port]().model.encoder
        assert archive._to_jsonable(rebuilt) == blob
    with pytest.raises(ValueError, match="outside the tpu_speech packages"):
        archive.config_object({"__dataclass__": "os.path.Foo"})


def test_use_chkpt_hparams_both_directions(tmp_path, jax_ctc):
    """Port direction: a JAX archive of the tiny CTC model served with
    ``--config_name spiral_tiny_test`` (a pretrain config, no CTC decoder)
    loads only with ``--use_chkpt_hparams true``, which rebuilds the model
    from the archive, to JAX's log-probs. JAX direction: the JAX CLI's
    ``--use_chkpt_hparams`` path (``config_object(...).model``) on the port's
    archive rebuilds a JAX model that gives the port's log-probs."""
    jcfg, params, infer = jax_ctc
    path = str(tmp_path / "jax.tpu_speech")
    jarchive.save_archive(path, jcfg, params)
    manifest, entries = _corpus(str(tmp_path))
    wavs, lens = _padded(entries)
    base = ["--model_type", "ctc_finetune", "--run_mode", "test", "--config_name",
            "spiral_tiny_test", "--test_manifest", manifest, "--device", "cpu",
            "--init_archive", path, "--save_logits", "true"]
    with pytest.raises(ValueError, match="strict checkpoint load failed"):
        run_spiral.main(base + ["--model_save_dir", str(tmp_path / "a")])
    run_spiral.main(base + ["--model_save_dir", str(tmp_path / "b"),
                            "--use_chkpt_hparams", "true"])
    got = np.concatenate([np.load(str(tmp_path / "b" / "logits" / f"logits_{n}.npy"))
                          for n in (2, 4, 5)])
    _serves_like(got, infer(params, wavs, lens)[0])

    cfg = spiral_tiny_ctc_char()
    runner = SpiralFinetuneRunner(cfg, str(tmp_path / "run"), CharTokenizer(cfg.model.labels),
                                  device="cpu")
    port_path = runner.save_archive()
    with tarfile.open(port_path) as tar:
        model_cfg = jarchive.config_object(json.loads(tar.extractfile("config.json").read())).model
    _, jparams, _ = jarchive.load_archive(port_path)
    jmodel = jax_ctc_model(type("Run", (), {"model": model_cfg}))
    specs, spec_lens = jst2vec.wav_to_spec(jax_encoder_cfg(model_cfg.encoder), jnp.asarray(wavs),
                                           jnp.asarray(lens))
    want, _ = jmodel.apply({"params": jparams}, specs, spec_lens, train=False)
    _serves_like(runner.infer(wavs, lens)[0].numpy(), want)


@pytest.mark.parametrize("spec", ["decoder", "encoder/feature_encoder/block1, layer_norm"])
def test_skip_var_loads_the_same_leaves_in_both_packages(tmp_path, jax_ctc, spec):
    """The same ``--load_model_skip_var`` string through the port's
    ``restore_from_archive`` and JAX's ``merge_params`` on the same archive:
    the same skipped and loaded paths; the skipped leaves keep the port's
    init, the loaded ones are the archive's."""
    jcfg, params, _ = jax_ctc
    path = str(tmp_path / "jax.tpu_speech")
    jarchive.save_archive(path, jcfg, params)
    cfg = spiral_tiny_ctc_char()
    runner = SpiralFinetuneRunner(cfg, str(tmp_path / "run"), CharTokenizer(cfg.model.labels),
                                  device="cpu")
    init = runner.weight_trees()["params"]
    skip = surgery.parse_skip_vars(spec)
    rep = runner.restore_from_archive(path, partial=False, skip=skip)
    _, jraw, _ = jarchive.load_archive(path)
    _, jrep = jsurgery.merge_params(init, jraw, partial=False, skip=jsurgery.parse_skip_vars(spec))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.skipped and rep.loaded
    now = dict(_leaves(runner.weight_trees()["params"]))
    init, src = dict(_leaves(init)), dict(_leaves(params))
    for k in rep.skipped:
        np.testing.assert_array_equal(now[k], init[k], err_msg=k)
    for k in rep.loaded:
        np.testing.assert_array_equal(now[k], src[k], err_msg=k)


# ---- the CLI's flag surface --------------------------------------------------

def _jax_parser():
    sys.path.insert(0, os.path.join(REPO, "cli"))
    import run_spiral as jax_cli

    return jax_cli.build_parser()


def test_every_jax_flag_parses_with_the_jax_default():
    """Every option of the JAX CLI's ``build_parser()`` exists in the port's
    parser with the same default; ``--device`` is the port's only extra; the
    defaults pretrain (``--model_type spiral --run_mode train``) and resume."""
    jp, pp = _jax_parser(), run_spiral.build_parser()
    jflags = {a.dest: a for a in jp._actions if a.option_strings and a.dest != "help"}
    pflags = {a.dest: a for a in pp._actions if a.option_strings and a.dest != "help"}
    assert len(jflags) == 42
    assert set(pflags) - set(jflags) == {"device"}
    for dest, a in jflags.items():
        assert pflags[dest].option_strings == a.option_strings, dest
        assert pp.get_default(dest) == jp.get_default(dest), dest
    args = pp.parse_args(["--config_name", "spiral_tiny_test"])
    assert (args.model_type, args.run_mode, args.resume_if_exists) == ("spiral", "train", True)
    argv = ["--data_dir=/d", "--manifest_dir=/m", "--model_save_dir=/s", "--tensorboard_dir=/tb",
            "--log_dir=/l", "--chkpt_dir=/c", "--config_path=conf/spiral",
            "--config_name=spiral_tiny_test", "--structured_config=true", "--num_gpus=8",
            "--num_nodes=2", "--use_horovod=false", "--resume_if_exists=true",
            "--run_mode=test", "--test_mode=multi_gpu", "--init_chkpt_dir=/i",
            "--init_chkpt_file=x.ckpt", "--init_model_partial=true",
            "--use_chkpt_hparams=false", "--load_model_skip_var=decoder",
            "--test_manifest=/t.json", "--model_type=ctc_finetune",
            "--finetune_from_scratch=false", "--dev_data_dup_factor=2",
            "--use_teacher_encoder=true", "--save_logits=true", "--beam_size=4",
            "--lm_manifest=/lm.json", "--lm_alpha=0.3", "--lm_order=3", "--export_model=/x",
            "--tokenizer_file=/tok", "--max_epochs=3", "--profile=true", "--seq_parallel=2",
            "--fsdp=true", "--node_rank=1", "--master_addr=h:1", "--streaming_eval=true",
            "--num_devices=1", "--set", "trainer.max_steps=2"]
    assert vars(pp.parse_args(argv)).items() >= {
        k: v for k, v in vars(jp.parse_args(argv)).items()}.items()


class _Reached(Exception):
    """Raised by a stand-in to stop the run where it was observed."""


@pytest.mark.parametrize("flag,value,item", [
    ("--seq_parallel", "2", None), ("--fsdp", "true", None), ("--num_nodes", "2", None),
    ("--node_rank", "0", None), ("--master_addr", "h:1", None), ("--num_gpus", "2", None),
    ("--num_devices", "4", None),
])
def test_unported_flags_stop_the_run_and_name_their_item(tmp_path, monkeypatch, flag, value,
                                                         item):
    """No flag refuses any more: ``--seq_parallel 2`` (with ``--num_devices
    2``) reaches the spawn with the seq size in its arguments. The
    multi-device flags reach the process group or the spawn
    with the JAX CLI's arguments (``initialize(coordinator_address=
    --master_addr, num_processes=--num_nodes, process_id=--node_rank)``, seen
    through stand-ins, so nothing is contacted); ``--num_nodes 2`` with no
    rendezvous fails with ``require_multiprocess``'s message; ``--fsdp`` reaches
    the runner's one-rank process group before the optimizer."""
    from tpu_speech_torch.parallel import distributed, launch

    _toy_pretrain_manifest(str(tmp_path))
    argv = ["--config_name", "spiral_tiny_test", "--device", "cpu",
            "--model_save_dir", str(tmp_path / "run"), "--manifest_dir", str(tmp_path)]
    calls = []

    def record(name):
        def stand_in(*args, **kw):
            calls.append((name, args, kw))
            raise _Reached
        return stand_in

    monkeypatch.setattr(distributed, "initialize", record("initialize"))
    monkeypatch.setattr(launch, "spawn", record("spawn"))
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    if flag == "--node_rank":  # the JAX CLI joins only with a coordinator
        monkeypatch.setenv("MASTER_ADDR", "h")
    if flag == "--seq_parallel":
        argv += ["--num_devices", "2"]
    if item is not None:
        with pytest.raises(SystemExit, match=f"Queue 1 item {item} "):
            run_spiral.main(argv + [flag, value])
    elif flag == "--num_nodes":
        with pytest.raises(RuntimeError, match=r"--num_nodes=2 but only 1 process\(es\) "
                                               "federated"):
            run_spiral.main(argv + [flag, value])
    else:
        with pytest.raises(_Reached):
            run_spiral.main(argv + [flag, value])
    if flag != "--fsdp":
        assert not os.path.exists(tmp_path / "run")  # stopped before any work
    if item is not None or flag == "--num_nodes":
        assert not calls
        return
    (name, args, kw), = calls
    if flag in ("--num_gpus", "--num_devices"):
        assert name == "spawn" and args[2] == int(value) and args[3] == "cpu"
    elif flag == "--seq_parallel":
        assert name == "spawn" and args[2] == 2 and args[1][-2:] == ["--seq_parallel", "2"]
    elif flag == "--fsdp":
        assert name == "initialize" and kw == {"device": torch.device("cpu")}
    else:
        want = {"coordinator_address": "h:1" if flag == "--master_addr" else None,
                "num_processes": None, "process_id": 0 if flag == "--node_rank" else None,
                "device": "cpu", "init_method": None}
        assert name == "initialize" and kw == want


def _toy_pretrain_manifest(root):
    """The runner test's corpus under the tiny pretrain config's manifest name."""
    manifest, _ = _corpus(root, n=2)
    os.replace(manifest, os.path.join(root, "manifest.json"))


def test_horovod_warns_and_the_test_mode_flag_is_ignored(tmp_path, capsys):
    manifest, _ = _corpus(str(tmp_path))
    run_spiral.main(["--model_type", "ctc_finetune", "--run_mode", "test", "--config_name",
                     "spiral_tiny_ctc_char", "--test_manifest", manifest, "--device", "cpu",
                     "--model_save_dir", str(tmp_path / "run"), "--use_horovod", "true",
                     "--test_mode", "anything", "--num_gpus", "1"])
    assert "--use_horovod" in capsys.readouterr().err


def test_exp_manager_versions_run_dirs(tmp_path):
    """``<base_dir>/<name>/run_N``: the next free version, or the latest with
    ``resume_if_exists``; an explicit dir wins; ``save_config`` writes the
    config."""
    base = str(tmp_path / "exp")
    a = ExpManager(name="x", base_dir=base, resume_if_exists=False)
    assert a.log_dir == os.path.join(base, "x", "run_0")
    b = ExpManager(name="x", base_dir=base, resume_if_exists=False)
    assert b.log_dir == os.path.join(base, "x", "run_1")
    c = ExpManager(name="x", base_dir=base, resume_if_exists=True,
                   tensorboard_dir=str(tmp_path / "tb"))
    assert c.log_dir == b.log_dir and os.path.exists(os.path.join(c.log_dir, "env.json"))
    assert ExpManager(explicit_log_dir=str(tmp_path / "e")).log_dir == str(tmp_path / "e")
    c.save_config(spiral_tiny_pretrain())
    with open(os.path.join(c.log_dir, "config.json")) as f:
        assert json.load(f)["model"]["encoder"]["n_negatives"] == 4
