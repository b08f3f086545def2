"""PyTorch port, the configs of ``cli/conf/spiral/`` and SPIRAL-large: each
``CONFIGS`` entry against its JAX experiment module leaf by leaf, SPIRAL-large's
parameter names and shapes against JAX's (``jax.eval_shape`` and the meta
device, nothing allocated), its weights through the converters both ways at
narrow widths, and YAML experiment files composed by both packages and run
through the port's CLI.
"""

import copy
import dataclasses
import json
import os
import sys
from importlib import import_module

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_speech.compat import torch_spiral
from tpu_speech.models.spiral import st2vec as jst2vec
from tpu_speech.train import spiral as jspiral
from tpu_speech.utils import archive as jarchive
from tpu_speech.utils import config as jconfig
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.compat.jax_spiral import (
    ctc_finetune_from_jax,
    ctc_finetune_to_jax,
    st2vec_from_jax,
    st2vec_to_jax,
)
from tpu_speech_torch.configs.spiral import CONFIGS
from tpu_speech_torch.models.spiral import st2vec
from tpu_speech_torch.models.spiral.encoder import (
    ConvLayerCfg,
    ConvTransformerBlockCfg,
    TransformerCfg,
    spiral_large_blocks,
)
from tpu_speech_torch.train.spiral_runner import build_model
from tpu_speech_torch.utils import archive
from tpu_speech_torch.utils.config import load_yaml_experiment

from tests.test_torch_spiral_ctc import jax_ctc_model, jax_encoder_cfg

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
NEW = ("spiral_base_finetune_ls100_subword", "spiral_base_finetune_ls100_subword_noise",
       "spiral_base_pretrain_ls960_noise", "spiral_large_finetune_ls100_char",
       "spiral_large_finetune_ls100_subword", "spiral_large_finetune_ls960_char",
       "spiral_large_finetune_ls960_subword", "spiral_large_pretrain_librilight",
       "spiral_toy_quality", "spiral_base_finetune_ls100_char_streaming",
       "spiral_tiny_stream_test")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch (the suite's six workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(name):
    sys.path.insert(0, os.path.join(REPO, "cli"))
    try:
        return copy.deepcopy(import_module(f"conf.spiral.{name}").cfg)
    finally:
        sys.path.pop(0)


def _blob(cfg, module):
    return json.loads(json.dumps(module._to_jsonable(cfg)))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _zeros(shape):  # a zero-strided array: no memory
    return np.broadcast_to(np.float32(0), tuple(shape))


@pytest.mark.parametrize("name", NEW)
def test_config_equals_its_jax_module(name):
    """Leaf by leaf: the dataclass trees as dicts, and the tagged archive
    JSON (which names each leaf's class)."""
    port, jcfg = CONFIGS[name](), _jax_cfg(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(jcfg)
    assert _blob(port, archive) == _blob(jcfg, jarchive)
    assert CONFIGS[name]() is not port and CONFIGS[name]() == port  # a fresh tree a call


def test_large_blocks_equal_jax():
    from tpu_speech.models.spiral.encoder import spiral_large_blocks as jax_blocks

    assert [dataclasses.asdict(b) for b in spiral_large_blocks()] == [
        dataclasses.asdict(b) for b in jax_blocks()]


@pytest.mark.parametrize("name,classes,n_lo,n_hi", [
    ("spiral_large_finetune_ls100_char", 29, 285e6, 300e6),
    ("spiral_large_finetune_ls100_subword", 1025, 285e6, 300e6),
])
def test_large_ctc_structure_matches_jax_without_compute(name, classes, n_lo, n_hi):
    """jax.eval_shape of the JAX model from the cli config against the port's
    state_dict shapes on the meta device, through the JAX package's
    converter (names and shapes)."""
    cli_cfg = _jax_cfg(name)
    jmodel = jax_ctc_model(cli_cfg, num_classes=classes)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 128)),
                            jnp.full((1,), 64), train=False))["params"]
    expected = {k: tuple(v.shape) for k, v in _leaves(shapes)}
    port = build_model(CONFIGS[name](), classes, device="meta")
    sd = {k: _zeros(v.shape) for k, v in port.state_dict().items()}
    (enc, _, _), (dec, _) = torch_spiral.convert_ctc_finetune(sd)
    got = {k: tuple(v.shape) for k, v in _leaves({"encoder": enc, "decoder": dec})}
    assert got == expected
    n_params = sum(int(np.prod(s)) for s in expected.values())
    assert n_params == sum(p.numel() for p in port.parameters())
    assert n_lo < n_params < n_hi
    assert len(port.encoder.feature_encoder.block_modules[3].layers) == 4
    assert len(port.encoder.feature_encoder.block_modules[6].layers) == 20


def test_large_pretrain_structure_matches_jax_without_compute():
    """The SPIRAL-large ST2Vec towers (512-wide projector and predictor, the
    EMA teacher) against JAX's init, shapes only."""
    cfg = CONFIGS["spiral_large_pretrain_librilight"]()
    jmodel = jst2vec.ST2VecEncoder(jax_encoder_cfg(cfg.model.encoder))
    state = jax.eval_shape(lambda: jspiral.init_spiral_state(
        jmodel, jax.random.PRNGKey(0), (1, 112, 128), optax.sgd(1.0)))
    want = [{k: tuple(v.shape) for k, v in _leaves(t)}
            for t in (state.params, state.batch_stats, state.teacher)]
    port = st2vec.ST2VecEncoder(cfg.model.encoder, pretraining=True, device="meta")
    sd = {k: _zeros(v.shape) for k, v in port.state_dict().items()}
    got = [{k: tuple(v.shape) for k, v in _leaves(t)}
           for t in torch_spiral.convert_st2vec(sd)]
    assert got == want
    assert port.projector.output_proj.weight.shape[0] == 512


def narrow_large_encoder(layers=(4, 20), **kw):
    """SPIRAL-large's block structure (three convs and a 512-style
    transformer, then a wide stride-2 conv, a 1x1 and a deeper transformer)
    at narrow widths: 16 mels, 32 and 48 wide, 4 heads (d_head 8 and 12)."""
    enc = CONFIGS["spiral_large_finetune_ls100_subword"]().model.encoder
    blocks = (
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(24, (5,), (2,), "ln", "relu", 0.1),
                         ConvLayerCfg(32, (5,), (2,), "ln", "relu", 0.1),
                         ConvLayerCfg(32, (1,), (1,), "ln", None, 0.0)),
            transformer=TransformerCfg(layers[0], 32, 64, 4, 0.1, encoder_layerdrop=0.1,
                                       conv_pos=8, conv_pos_groups=4)),
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(96, (5,), (2,), "ln", "relu", 0.1),
                         ConvLayerCfg(48, (1,), (1,), "ln", None, 0.0)),
            transformer=TransformerCfg(layers[1], 48, 96, 4, 0.1, encoder_layerdrop=0.1,
                                       conv_pos=8, conv_pos_groups=4)),
    )
    return dataclasses.replace(enc, blocks=blocks, num_features=16, projector_dim=16,
                               predictor_convs=(ConvLayerCfg(16, (5,), (1,), "bn", "relu",
                                                             0.0, bias=None),) * 2, **kw)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        for name, b in module.named_buffers():
            if b.is_floating_point():
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return module


@pytest.mark.parametrize("name,classes", [("spiral_large_finetune_ls100_char", 29),
                                          ("spiral_large_finetune_ls100_subword", 41)])
def test_narrow_large_ctc_converts_both_ways_exactly(name, classes):
    """The large block structure (4 + 20 layers, the 'ln' conv norms, the
    char head's LayerNorm convs or the subword head) at narrow widths:
    port -> JAX trees -> port is exact, and the JAX package's converter reads
    the port's state_dict to the same trees."""
    cfg = CONFIGS[name]()
    cfg.model.encoder = narrow_large_encoder()
    cfg.model.decoder = dataclasses.replace(
        cfg.model.decoder, upsample_filters=32 if cfg.model.decoder.upsample_rate else
        cfg.model.decoder.upsample_filters,
        conv_layers=tuple(dataclasses.replace(c, filters=32)
                          for c in cfg.model.decoder.conv_layers))
    model = _randomize(build_model(cfg, classes), 5)
    sd = model.state_dict()
    params, bstats = ctc_finetune_to_jax(sd)
    back = ctc_finetune_from_jax(params, bstats)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    (enc, enc_bs, _), (dec, dec_bs) = torch_spiral.convert_ctc_finetune(
        {k: v.numpy() for k, v in sd.items()})
    ours = dict(_leaves(params))
    theirs = dict(_leaves({"encoder": enc, "decoder": dec}))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg="/".join(k))
    if name.endswith("char"):  # the char head's convs carry LayerNorms
        assert any("norm" in "/".join(k) for k in ours if k[0] == "decoder")


def test_narrow_large_st2vec_converts_both_ways_exactly():
    cfg = CONFIGS["spiral_large_pretrain_librilight"]()
    model = _randomize(st2vec.ST2VecEncoder(narrow_large_encoder(), pretraining=True), 6)
    sd = model.state_dict()
    trees = st2vec_to_jax(sd)
    back = st2vec_from_jax(*trees)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    assert cfg.model.encoder.target_momentum == 0.99


# ---- YAML experiment files ---------------------------------------------------

YAML = """\
base: {base}
model:
  optim:
    lr: 0.002
    sched:
      warmup_steps: 7
  test_ds:
    batch_size: 3
  freeze_finetune_updates: 5
trainer:
  max_steps: 11
  accumulate_grad_batches: 2
"""


@pytest.mark.parametrize("base", ["spiral_base_finetune_ls100_char",
                                  "spiral_large_finetune_ls100_subword",
                                  "spiral_base_pretrain_ls960_noise"])
def test_yaml_experiment_composes_to_the_jax_config(tmp_path, base):
    """The JAX CLI's front end (``load_yaml_experiment``, the base module's
    cfg, ``apply_overrides``) against the port's ``run_spiral.load_config`` on
    the same file, by its path and by its name under ``--config_path``."""
    path = tmp_path / "exp.yaml"
    path.write_text(YAML.format(base=base))
    jbase, joverrides = jconfig.load_yaml_experiment(str(path))
    pbase, poverrides = load_yaml_experiment(str(path))
    assert (pbase, poverrides) == (jbase, joverrides)
    jcfg = _jax_cfg(jbase)
    jconfig.apply_overrides(jcfg, joverrides)
    parser = run_spiral.build_parser()
    for argv in (["--config_name", str(path)],
                 ["--config_name", "exp.yaml", "--config_path", str(tmp_path)],
                 ["--config_name", "exp", "--config_path", str(tmp_path),
                  "--structured_config", "false"],
                 ["--config_name", "exp", "--config_path", str(tmp_path)]):
        cfg = run_spiral.load_config(parser.parse_args(argv))
        assert _blob(cfg, archive) == _blob(jcfg, jarchive), argv
        assert cfg.trainer.max_steps == 11 and cfg.model.optim.lr == 0.002


def test_yaml_errors(tmp_path):
    parser = run_spiral.build_parser()
    (tmp_path / "nobase.yaml").write_text("trainer:\n  max_steps: 2\n")
    with pytest.raises(ValueError, match="base:"):
        run_spiral.load_config(parser.parse_args(["--config_name",
                                                  str(tmp_path / "nobase.yaml")]))
    (tmp_path / "bad.yaml").write_text("base: spiral_tiny_test\ntrainer:\n  nope: 2\n")
    with pytest.raises(Exception, match="nope"):
        run_spiral.load_config(parser.parse_args(["--config_name", str(tmp_path / "bad.yaml")]))
    (tmp_path / "stream.yaml").write_text("base: spiral_tiny_stream_test\n")
    stream = run_spiral.load_config(parser.parse_args(["--config_name",
                                                       str(tmp_path / "stream.yaml")]))
    assert stream.model.encoder.streaming.chunk_frames == 32  # a ported base composes
    with pytest.raises(SystemExit, match="no YAML config"):
        run_spiral.load_config(parser.parse_args(
            ["--config_name", "missing", "--config_path", str(tmp_path),
             "--structured_config", "false"]))
    with pytest.raises(SystemExit, match="the port's configs are"):
        run_spiral.load_config(parser.parse_args(["--config_name", "spiral_huge"]))


def test_yaml_experiment_runs_through_the_cli(tmp_path):
    """A YAML file over the tiny CTC config serves the test manifest through
    ``run_spiral.main`` with its overrides applied (the saved config)."""
    from tests.test_torch_runner import _corpus

    manifest, entries = _corpus(str(tmp_path))
    (tmp_path / "conf").mkdir()
    (tmp_path / "conf" / "tiny.yaml").write_text(
        "base: spiral_tiny_ctc_char\nmodel:\n  test_ds:\n    batch_size: 5\n")
    results = run_spiral.main([
        "--model_type", "ctc_finetune", "--run_mode", "test", "--config_name", "tiny",
        "--config_path", str(tmp_path / "conf"), "--structured_config", "false",
        "--test_manifest", manifest, "--model_save_dir", str(tmp_path / "run"),
        "--save_logits", "true", "--device", "cpu"])
    assert results["n"] == len(entries)
    # test_ds.batch_size 5: one batch of all five
    assert os.listdir(tmp_path / "run" / "logits") == [f"logits_{len(entries)}.npy"]
