"""PyTorch port, the optimizer and schedule registry against the JAX package's.

``train/optim.py::make_optimizer`` and ``make_schedule`` against
``tpu_speech/train/optim.py``'s (optax): each of the eight optimizer names
over three updates on the same gradients (parameters within 2e-5), each of
the six schedules at every step from 0 to ``max_steps`` (1e-6 relative), the
unknown names' errors, and a YAML experiment naming Novograd's parameters
composed as the JAX CLI composes it. The parameter classes are held to
JAX's in ``tests/test_torch_host.py``, Novograd sharded over two ranks in
``tests/test_torch_tp.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_speech.train import optim as joptim
from tpu_speech.utils import config as jconfig
from tpu_speech_torch.cli import run_spiral
from tpu_speech_torch.train import optim
from tpu_speech_torch.utils import config as pconfig
from tests.test_torch_spiral_large import _blob, _jax_cfg
from tpu_speech.utils import archive as jarchive
from tpu_speech_torch.utils import archive

SHAPES = [(4, 3), (5,), (2, 2, 3), (1,)]
STEPS = 3
SCHED = dict(name="CosineAnnealing", warmup_steps=1, max_steps=6, min_lr=1e-4)

# (name, the port's config, its fields): each optimizer with the values a
# recipe would set, a schedule across the warmup edge (rprop: a constant lr)
CASES = {
    "adam": (pconfig.AdamParams, dict(lr=3e-2)),
    "adamw": (pconfig.AdamWParams, dict(lr=3e-2, weight_decay=0.05)),
    "novograd": (pconfig.NovogradParams, dict(weight_decay=1e-3)),
    "sgd": (pconfig.SGDParams, dict(momentum=0.9, weight_decay=1e-2)),
    "adadelta": (pconfig.AdamWParams, dict(name="adadelta", lr=1.0, eps=1e-6)),
    "adamax": (pconfig.AdamWParams, dict(name="adamax", lr=2e-2, eps=1e-8,
                                         betas=(0.9, 0.99))),
    "adagrad": (pconfig.AdamWParams, dict(name="adagrad", lr=5e-2, eps=1e-7)),
    "rprop": (pconfig.AdamWParams, dict(name="rprop", lr=1e-2)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_twin(cfg):
    """The JAX package's dataclass of the same name and fields."""
    fields = dataclasses.asdict(cfg)
    sched = fields.pop("sched")
    return getattr(jconfig, type(cfg).__name__)(
        **fields, sched=None if sched is None else jconfig.SchedParams(**sched))


def _cfg(name):
    cls, fields = CASES[name]
    cfg = cls(**fields)
    if name != "rprop":
        cfg.sched = pconfig.SchedParams(**SCHED)
    return cfg


def test_the_registry_names_the_jax_optimizers():
    assert optim.OPTIMIZERS == joptim.OPTIMIZERS and len(CASES) == 8


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_optimizer_matches_optax_over_three_steps(name):
    """``make_optimizer`` from one config in both packages, three updates on
    the same gradients (a zero gradient element in the third, which Rprop's
    sign rule and Adagrad's accumulator see); every parameter within 2e-5
    after each update. The update of each is its optax chain's, not
    ``torch.optim``'s (eps placement, accumulator starts, coupled decay)."""
    rng = np.random.default_rng(0)
    cfg = _cfg(name)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(STEPS)]
    grads[2][0][0, 0] = 0.0
    grads[1][1] = -grads[0][1]  # every sign flips: Rprop shrinks and skips
    tx = joptim.make_optimizer(_jax_twin(cfg), 100)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = optim.make_optimizer(cfg, tp, 100)
    for step, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-5, rtol=0,
                                       err_msg=f"{name} step {step}")
    assert opt.count == STEPS
    assert not any(isinstance(opt, c) for c in (torch.optim.Adam, torch.optim.SGD))


def _sched_cfg(name):
    fields = dict(name=name, warmup_steps=3, max_steps=12, min_lr=1e-5)
    if name == "PolynomialHoldDecayAnnealing":
        fields.update(warmup_steps=0, warmup_ratio=0.25, hold_ratio=0.25)
    if name == "NoamAnnealing":
        fields["d_model"] = 144
    return pconfig.AdamWParams(lr=2e-3, sched=pconfig.SchedParams(**fields))


@pytest.mark.parametrize("name", ["CosineAnnealing", "SquareAnnealing", "SquareRootAnnealing",
                                  "InverseSquareRootAnnealing", "PolynomialHoldDecayAnnealing",
                                  "NoamAnnealing"])
def test_each_schedule_matches_jax_at_every_step(name):
    """``make_schedule`` (the lr rescale 0.5 included) at steps 0 ...
    max_steps in both packages, within 1e-6 relative."""
    cfg = _sched_cfg(name)
    ours = optim.make_schedule(cfg, 100, lr_scale=0.5)
    theirs = joptim.make_schedule(_jax_twin(cfg), 100, lr_scale=0.5)
    for count in range(cfg.sched.max_steps + 1):
        want = float(theirs(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(ours(count), want, rtol=1e-6, atol=0, err_msg=str(count))


def test_unknown_names_fail_as_in_jax():
    cfg = pconfig.AdamWParams(name="lamb")
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        optim.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))], 10)
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        joptim.make_optimizer(_jax_twin(cfg), 10)
    cfg = pconfig.AdamWParams(sched=pconfig.SchedParams(name="Linear"))
    with pytest.raises(ValueError, match="unknown schedule 'Linear'"):
        optim.make_schedule(cfg, 10)
    with pytest.raises(ValueError, match="unknown schedule 'Linear'"):
        joptim.make_schedule(_jax_twin(cfg), 10)
    with pytest.raises(TypeError, match="a constant"):
        optim.make_optimizer(pconfig.AdamWParams(name="rprop", sched=pconfig.SchedParams()),
                             [torch.nn.Parameter(torch.zeros(2))], 10)


NOVOGRAD_YAML = """\
base: spiral_base_finetune_ls100_char
model:
  optim:
    name: novograd
    lr: 0.01
    eps: 1.0e-08
    betas: [0.95, 0.25]
    weight_decay: 0.0
    sched:
      name: NoamAnnealing
      warmup_steps: 5
      d_model: 144
"""


def test_a_yaml_experiment_naming_novograd_composes_to_the_jax_config(tmp_path):
    """The optim block of ``NovogradParams``' defaults in a YAML experiment:
    the port's ``run_spiral.load_config`` composes what the JAX CLI's front
    end composes, and builds the Novograd and Noam schedule of those
    parameters."""
    path = tmp_path / "novograd.yaml"
    path.write_text(NOVOGRAD_YAML)
    jbase, joverrides = jconfig.load_yaml_experiment(str(path))
    jcfg = _jax_cfg(jbase)
    jconfig.apply_overrides(jcfg, joverrides)
    cfg = run_spiral.load_config(run_spiral.build_parser().parse_args(
        ["--config_name", str(path)]))
    assert _blob(cfg, archive) == _blob(jcfg, jarchive)
    want = dataclasses.asdict(pconfig.NovogradParams())
    got = dataclasses.asdict(cfg.model.optim)
    assert {k: got[k] for k in want if k != "sched"} == \
        {k: v for k, v in want.items() if k != "sched"}
    opt = optim.make_optimizer(cfg.model.optim, [torch.nn.Parameter(torch.zeros(2))], 10)
    assert isinstance(opt, optim.Novograd)
    assert opt.defaults["betas"] == (0.95, 0.25) and opt.defaults["eps"] == 1e-8
