"""PyTorch port, ``parallel/`` against ``tpu_speech/parallel/`` and the
multi-rank CLI on the CPU.

The host-side pieces hold against the JAX package on its 8 virtual CPU
devices: FSDP's choice of dimension for every leaf of the tiny pretrain and
finetune states, the batch slices of ``shard_batch`` / ``shard_microbatches``
against ``addressable_shards``, the environment surface of ``initialize``
(with ``init_process_group`` stood in, so nothing is contacted), the lr
rescale. The dropout key takes the global row: two halves at offsets 0 and
B/2 reproduce the whole batch's masks, outputs and gradients bit for bit.
Then ``run_spiral`` pretrains, finetunes (FSDP) and evaluates the tiny
configs over two gloo ranks (``--num_devices 2``), and ``--fsdp true`` runs in
one process, equal to the run without it.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.parallel import mesh as jmesh
from tpu_speech.train import optim as joptim
from tpu_speech.train import spiral as jspiral
from tpu_speech.train.spiral_runner import _lr_scale
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.configs.spiral import spiral_tiny_pretrain
from tpu_speech_torch.data.wav import write_wav
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.ops.fused_attention import dropout_keep_mask, qkv_attention_plain
from tpu_speech_torch.parallel import distributed, mesh
from tpu_speech_torch.train.optim import lr_scale
from tests.test_torch_spiral_ctc import jax_ctc_model, jax_encoder_cfg

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- FSDP placement, batch slices ---------------------------------------------

def _jax_dims(spec_tree, leaves):
    """JAX's NamedSharding leaves -> the sharded dimension or 'replicated'."""
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(specs) == len(leaves)
    out = []
    for s, leaf in zip(specs, leaves):
        dims = [i for i, p in enumerate(s.spec) if p is not None]
        out.append(dims[0] if dims else mesh.REPLICATED)
    return out


def _tiny_states():
    """The tiny pretrain state (AdamW moments included) and finetune params
    as the JAX package builds them."""
    cfg = spiral_tiny_pretrain()
    jcfg = jax_encoder_cfg(cfg.model.encoder)
    tx = joptim.make_optimizer(cfg.model.optim, 100)
    pre = jspiral.init_spiral_state(jst2vec.ST2VecEncoder(jcfg), jax.random.PRNGKey(0),
                                    (2, 112, 16), tx)
    from tpu_speech_torch.configs.spiral import spiral_tiny_ctc_char

    model = jax_ctc_model(spiral_tiny_ctc_char())
    ft = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 112, 16)), jnp.full((1,), 112),
        train=False)["params"]
    return {"pretrain": jax.device_get(pre), "finetune": (ft, tx.init(ft))}


@pytest.fixture(scope="module")
def tiny_states():
    return _tiny_states()


@pytest.mark.parametrize("which", ["pretrain", "finetune"])
@pytest.mark.parametrize("min_size", [None, 256])
def test_fsdp_shardings_choose_the_jax_dimension_for_every_leaf(tiny_states, which, min_size):
    """Every leaf of the tiny states (params, BatchNorm statistics, teacher,
    AdamW moments) on a 2-device data axis: the port's rule picks JAX's
    dimension, or leaves it replicated where JAX does, at the default
    threshold and at 256 elements (where some leaves shard)."""
    state = tiny_states[which]
    jax_mesh = jmesh.make_mesh(n_devices=2)
    kw = {} if min_size is None else {"min_size": min_size}
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    named = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in leaves]
    got = mesh.fsdp_shardings(2, named, min_size)
    want = _jax_dims(jmesh.fsdp_shardings(jax_mesh, state, **kw), [v for _, v in named])
    got = [g if g == mesh.REPLICATED else g.dim for g in got.values()]
    assert got == want
    if min_size is not None:
        assert any(w != mesh.REPLICATED for w in want)


def test_fsdp_shardings_takes_the_first_of_equal_dimensions():
    got = mesh.fsdp_shardings(4, [("sq", torch.zeros(128, 128)), ("odd", torch.zeros(3, 6001)),
                                  ("wide", torch.zeros(8, 4096)), ("small", torch.zeros(64))])
    assert got["sq"].dim == 0 and got["wide"].dim == 1
    assert got["odd"] == got["small"] == mesh.REPLICATED


def _host_batch(rng, b=4):
    return {"wavs": rng.standard_normal((b, 100)).astype(np.float32),
            "wav_lens": np.arange(b, dtype=np.int32) + 50,
            "time_mask": rng.random((b, 7, 3)) < 0.5, "shift_k": np.int32(2)}


def _addressable(arr):
    return [np.asarray(s.data) for s in sorted(arr.addressable_shards, key=lambda s: s.device.id)]


def test_shard_batch_slices_equal_the_jax_addressable_shards(rng):
    jax_mesh = jmesh.make_mesh(n_devices=2)
    batch = _host_batch(rng)
    placed = jmesh.shard_batch(jax_mesh, batch)
    for r in (0, 1):
        got = mesh.shard_batch(batch, r, 2)
        for k, v in placed.items():
            np.testing.assert_array_equal(got[k], _addressable(v)[r], err_msg=k)
    stacked = {k: np.stack([v, v + 1]) for k, v in batch.items()}
    placed = jmesh.shard_microbatches(jax_mesh, stacked)
    for r in (0, 1):
        got = mesh.shard_microbatches(stacked, r, 2)
        for k, v in placed.items():
            np.testing.assert_array_equal(got[k], _addressable(v)[r], err_msg=k)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(_host_batch(rng, b=3), 0, 2)


# ---- the process group --------------------------------------------------------

def test_one_process_collectives_are_the_identity():
    assert not distributed.is_initialized()
    x = np.array([3, 4, 5], np.int64)
    assert distributed.allreduce_sum(x) is not None
    np.testing.assert_array_equal(distributed.allreduce_sum(x), x)
    t = torch.arange(3.0)
    assert distributed.all_reduce_(t) is t and torch.equal(t, torch.arange(3.0))
    assert distributed.broadcast_object({"a": 1}) == {"a": 1}
    distributed.barrier()
    assert (distributed.process_count(), distributed.process_index(),
            distributed.is_primary()) == (1, 0, True)
    g = [torch.ones(2)]
    params = [torch.nn.Parameter(torch.zeros(2))]
    params[0].grad = g[0]
    assert mesh.allreduce_grads(params) == 0 and torch.equal(params[0].grad, torch.ones(2))


@pytest.fixture
def seen_init(monkeypatch):
    """``init_process_group`` stood in: the calls' arguments, nothing
    joined."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed, "_device", None)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "NODE_RANK", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return calls


def test_initialize_reads_the_environment_in_the_jax_order(seen_init, monkeypatch):
    """Explicit arguments first, then MASTER_ADDR:MASTER_PORT, WORLD_SIZE and
    NODE_RANK (the reference's DDP surface); torchrun's RANK before
    NODE_RANK; the default port; gloo on the CPU."""
    monkeypatch.setenv("MASTER_ADDR", "a")
    monkeypatch.setenv("MASTER_PORT", "5")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("NODE_RANK", "2")
    distributed.initialize(device="cpu")
    distributed.initialize("b:7", 4, 1, device="cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_PORT")
    distributed.initialize(device="cpu")
    got = [(c["init_method"], c["world_size"], c["rank"], c["backend"]) for c in seen_init]
    assert got == [("tcp://a:5", 3, 2, "gloo"), ("tcp://b:7", 4, 1, "gloo"),
                   ("tcp://a:12355", 3, 1, "gloo")]


def test_initialize_without_a_coordinator(seen_init):
    """World 1 joins an in-memory store; a larger world needs a
    coordinator; a file store comes as a function argument."""
    distributed.initialize(device="cpu")
    assert seen_init[0]["world_size"] == 1 and "store" in seen_init[0]
    with pytest.raises(RuntimeError, match="needs a coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    distributed.initialize(num_processes=2, process_id=1, device="cpu", backend="gloo",
                           init_method="file:///x")
    assert seen_init[-1]["init_method"] == "file:///x" and seen_init[-1]["rank"] == 1
    assert distributed.rendezvous()["local_rank"] == 0


def test_require_multiprocess_fails_loudly():
    distributed.require_multiprocess(1)
    with pytest.raises(RuntimeError, match=r"--num_nodes=2 but only 1 process\(es\) federated"):
        distributed.require_multiprocess(2)


def test_the_seq_and_model_axes_build_the_jax_layout():
    """``mesh_layout`` (the shape and axis names ``make_mesh`` builds) gives
    JAX's mesh on the 8 virtual devices for each (seq, model), with rank r
    where JAX puts device r (the model axis over four gloo ranks:
    ``tests/test_torch_tp.py``); on a one-rank group a seq or model axis
    asks for a world it divides, and the axes of 1 build the data mesh with
    no model axis (rank and world are the data coordinate)."""
    for sp, mp in ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (2, 4), (1, 8)):
        jm = jmesh.make_mesh(n_devices=8, seq_parallel=sp, model_parallel=mp)
        shape, names = mesh.mesh_layout(8, sp, mp)
        assert names == tuple(jm.axis_names) and shape == tuple(jm.devices.shape)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        assert np.array_equal(np.arange(8).reshape(shape), ids), (sp, mp)
    distributed.initialize(device="cpu")
    try:
        with pytest.raises(ValueError, match="seq_parallel=2 does not divide the 1 ranks"):
            mesh.make_mesh(seq_parallel=2)
        with pytest.raises(ValueError, match="model_parallel=2 x seq_parallel=1 does not "
                                             "divide the 1 ranks"):
            mesh.make_mesh(model_parallel=2)
        m = mesh.make_mesh(seq_parallel=1, model_parallel=1)
        assert m.mesh_dim_names == (mesh.DATA_AXIS,) and mesh.model_size(m) == 1
        assert mesh.data_axis(None) == (0, 1) and mesh.seq_size(None) == 1
        assert distributed.data_coordinate() == (0, 1) and distributed.batch_count() == 1
    finally:
        distributed.shutdown()


def test_lr_scale_counts_the_ranks():
    class M:
        expected_gpu_num = 8

    for world, accum in ((1, 1), (2, 1), (2, 2), (8, 2)):
        assert lr_scale(M(), world, accum) == _lr_scale(M(), world, accum)
    assert lr_scale(M(), 2, 1) == 0.25


# ---- the dropout key and the generators ----------------------------------------

def test_dropout_masks_take_the_global_row():
    """Halves at offsets 0 and B/2 are the whole batch's masks; offset 0 is
    the mask without one."""
    whole = dropout_keep_mask(123, 4, 3, 40, 0.1)
    halves = torch.cat([dropout_keep_mask(123, 2, 3, 40, 0.1, b0=0),
                        dropout_keep_mask(123, 2, 3, 40, 0.1, b0=2)])
    assert torch.equal(whole, halves)
    assert torch.equal(dropout_keep_mask(123, 2, 3, 40, 0.1, b0=0), whole[:2])
    assert not torch.equal(whole[:2], whole[2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_halves_at_their_offsets_equal_the_whole_batch(rng, dtype):
    """The plain attention with dropout: outputs and qkv gradients of the two
    halves (b0 = 0 and 2) equal the whole batch's bit for bit."""
    qkv = torch.tensor(rng.standard_normal((4, 24, 3 * 32)).astype(np.float32)).to(dtype)
    mask = torch.zeros(4, 24, dtype=torch.bool)
    mask[1, 20:] = mask[3, 15:] = True
    dout = torch.tensor(rng.standard_normal((4, 24, 32)).astype(np.float32)).to(dtype)

    def run(x, m, d, b0):
        x = x.clone().requires_grad_(True)
        out = qkv_attention_plain(x, 4, m, 0.1, 77, b0)
        out.backward(d)
        return out.detach(), x.grad

    out, grad = run(qkv, mask, dout, 0)
    parts = [run(qkv[s], mask[s], dout[s], s.start) for s in (slice(0, 2), slice(2, 4))]
    assert torch.equal(out, torch.cat([p[0] for p in parts]))
    assert torch.equal(grad, torch.cat([p[1] for p in parts]))
    assert not torch.equal(run(qkv[2:], mask[2:], dout[2:], 0)[0], out[2:])


def test_rank_generators():
    """The host generator is the same on every rank, the device generator
    differs, and rank 0's are the one-process run's."""
    one = DropoutRng.seeded(5, "cpu")
    ranks = [DropoutRng.seeded(5, "cpu", rank=r, row0=2 * r) for r in range(3)]
    host = [[g.attention_seed() for _ in range(3)] for g in ranks]
    assert host[0] == host[1] == host[2] == [one.attention_seed() for _ in range(3)]
    dev = [torch.rand(4, generator=g.device) for g in ranks]
    assert torch.equal(dev[0], torch.rand(4, generator=one.device))
    assert not torch.equal(dev[0], dev[1]) and not torch.equal(dev[1], dev[2])
    assert [g.row0 for g in ranks] == [0, 2, 4]


# ---- the CLI over two gloo ranks --------------------------------------------------

def _corpus(root, n=8):
    r = np.random.default_rng(0)
    rows = []
    for i in range(n):
        d = 0.6 + 0.05 * i
        path = os.path.join(root, f"u{i}.wav")
        write_wav(path, (r.standard_normal(int(SR * d)) * 0.1).astype(np.float32), SR)
        rows.append(json.dumps({"audio_filepath": path, "duration": d,
                                "text": "hello world" if i % 2 else "speech"}))
    for name in ("manifest.json", "librivox-train-clean-100.json", "librivox-dev-other.json"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    return os.path.join(root, "manifest.json")


def test_cli_pretrains_finetunes_and_evaluates_over_two_ranks(tmp_path, capfd):
    """``--device cpu --num_devices 2``: two pretrain updates, then two bf16
    finetune updates with ``--fsdp true`` from the pretrained encoder, each
    over two spawned gloo ranks. The finetune run's validation decodes 9
    utterances over the two ranks (rank 0 one batch more than rank 1) on the
    whole float32 weights; its WER, CER, n and SER equal one process's
    test-mode evaluation of the saved weights."""
    _corpus(str(tmp_path), n=9)
    common = ["--device", "cpu", "--manifest_dir", str(tmp_path),
              "--set", "model.train_ds.num_workers=1"]
    pre = run_spiral.main(["--config_name", "spiral_tiny_test", "--num_devices", "2",
                           "--model_save_dir", str(tmp_path / "pre"),
                           "--set", "trainer.max_steps=2", *common])
    assert pre["iteration"] == 2 and len(pre["steps"]) == 2
    assert all(np.isfinite(m["loss"]) for m in pre["steps"])
    assert os.path.exists(tmp_path / "pre" / "ckpt" / "step_0000000002.pt")
    ft = run_spiral.main(["--model_type", "ctc_finetune", "--config_name", "spiral_tiny_ctc_char",
                          "--num_devices", "2", "--fsdp", "true",
                          "--model_save_dir", str(tmp_path / "ft"),
                          "--init_chkpt_dir", str(tmp_path / "pre"),
                          "--init_chkpt_file", "st2vec.pt", "--set", "trainer.max_steps=2",
                          "--set", "model.precision=bf16", "--set",
                          "trainer.val_check_interval_epochs=1", "--set",
                          "model.validation_ds.num_workers=1", *common])
    assert ft["iteration"] == 2 and all(np.isfinite(m["loss"]) for m in ft["steps"])
    val = ft["validation"]
    one = run_spiral.main(["--model_type", "ctc_finetune", "--run_mode", "test", "--config_name",
                           "spiral_tiny_ctc_char", "--test_manifest",
                           str(tmp_path / "librivox-dev-other.json"), "--init_chkpt_dir",
                           str(tmp_path / "ft"), "--init_chkpt_file", "ctc_finetune.pt",
                           "--device", "cpu", "--model_save_dir", str(tmp_path / "t1")])
    for k in ("wer", "cer", "n", "ser"):
        assert val[k] == pytest.approx(one[k], abs=0), k
    assert val["n"] == 9 and len(val["hyps"]) == 5 and len(one["hyps"]) == 9
    assert val["hyps"] == one["hyps"][0::2]  # rank 0's shard
    out = capfd.readouterr().out  # the spawned ranks write to the inherited stdout
    assert out.count("Validation: WER =") == 1 and "TEST: WER =" in out


def test_fsdp_in_one_process_equals_the_run_without_it(tmp_path, monkeypatch):
    """``--fsdp true`` in one process: a one-rank mesh (nothing federated),
    with the leaves above 256 elements sharded; the saved weights equal
    those of the same run without it."""
    monkeypatch.setattr(mesh, "MIN_SIZE", 256)
    _corpus(str(tmp_path))
    argv = ["--config_name", "spiral_tiny_test", "--device", "cpu", "--manifest_dir",
            str(tmp_path), "--set", "model.train_ds.num_workers=1",
            "--set", "trainer.max_steps=2"]
    plain = run_spiral.main(argv + ["--model_save_dir", str(tmp_path / "plain")])
    try:
        sharded = run_spiral.main(argv + ["--fsdp", "true", "--model_save_dir",
                                          str(tmp_path / "fsdp")])
        assert distributed.process_count() == 1
    finally:
        distributed.shutdown()
    np.testing.assert_allclose([m["loss"] for m in sharded["steps"]],
                               [m["loss"] for m in plain["steps"]], rtol=1e-6)
    a = torch.load(plain["state_dict"], weights_only=True)
    b = torch.load(sharded["state_dict"], weights_only=True)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=1e-6, msg=k)
