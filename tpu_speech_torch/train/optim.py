"""Optimizers with optax's semantics, and the global-norm gradient clip.

Port of ``tpu_speech/train/optim.py``: the registry of ``_build:63`` (the
eight names of ``OPTIMIZERS``), ``make_schedule:96`` and
``make_optimizer:125``, the clip of ``train/spiral.py:210-215``, and
``clip_subtree_by_global_norm:24``, Grad-TTS's per-module clip.

Each optimizer is its optax chain step for step, with optax's defaults where
JAX passes no value, which ``torch.optim``'s versions are not (their
accumulators start elsewhere, their eps sits elsewhere, their decay is
coupled otherwise):

- ``AdamW`` is ``optax.adamw`` (and ``optax.adam`` at ``weight_decay = 0``):
  the moments update as ``(1 - b) * g^k + b * m``; the bias-corrected
  ``mu_hat / (sqrt(nu_hat) + eps)``, eps outside the sqrt; then ``+
  weight_decay * p`` on EVERY parameter (optax decays biases and norms too);
- ``Novograd`` is ``optax.novograd``: a second moment per parameter, the
  squared norm of its whole gradient (``nu = |g|^2`` at the first update,
  then ``b2 nu + (1 - b2) |g|^2``), and ``mu = b1 mu + g / (sqrt(nu) + eps)
  + weight_decay * p`` (no bias correction);
- ``SGD`` is ``optax.sgd`` with ``momentum`` as ``trace`` (``t = g + m t``),
  chained after ``add_decayed_weights`` (``g + weight_decay * p``) as
  ``sgd:53`` chains it;
- ``Adadelta`` is ``optax.adadelta(lr, eps=eps)``: rho 0.9, ``u = sqrt(e_x
  + eps) / sqrt(e_g + eps) * g`` between the two moving averages;
- ``Adamax`` is ``optax.adamax``: ``nu = max(|g| + eps, b2 nu)``, the first
  moment bias-corrected, ``u = mu_hat / nu``;
- ``Adagrad`` is ``optax.adagrad(lr, eps=eps)``: the sum of squares starts
  at 0.1, ``u = g / sqrt(sum + eps)``;
- ``Rprop`` is ``optax.rprop(lr)``: per-element step sizes from ``lr``,
  grown by 1.2 or shrunk by 0.5 by the sign of ``g`` times the stored
  update's sign, clipped to [1e-6, 50]; a sign change skips the element.
  As optax's ``scale_by_rprop``, a step applies the update the previous
  step stored (none on the first) and stores ``step_size * sign(g)``. The
  step sizes are the lr: it takes no schedule, as optax's does not.

Then ``p -= lr(count) * u`` (Rprop: ``p -= u``), with ``count`` the number
of updates before this one (the schedule sees 0 on the first step).

Every update runs as ``torch._foreach_*`` calls over all parameters (a
handful of launches per step on the card). Every parameter needs a
gradient: the steps fill the ones a forward did not reach with zeros, as JAX
differentiates every leaf.

Under FSDP or TP (``parallel/mesh.py::shard_state_fsdp``,
``shard_params_tp``) the parameters, their gradients and the state of the
sharded ones are ``DTensor`` shards: the update runs on each rank's local
shards, as JAX's optimizers run shard-wise. Novograd's norm and the
global-norm clip sum a sharded gradient's squares over its shard group
first, so they see the whole gradient.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from tpu_speech_torch.parallel.mesh import is_sharded, locals_, shard_group
from tpu_speech_torch.train.schedules import SCHEDULES, polynomial_hold, warmup_cosine

Schedule = Union[float, Callable[[int], float]]


def _lr(schedule: Schedule, count: int) -> float:
    return schedule(count) if callable(schedule) else float(schedule)


def squared_norms(tensors) -> list:
    """``|t|^2`` of each tensor as 0-d float32 tensors; a sharded one's
    squares summed over its shard group (one all-reduce a group)."""
    tensors = list(tensors)
    if not tensors:
        return []
    sq = list(torch.stack(torch._foreach_norm(locals_(tensors))).square())
    groups = {}
    for i, t in enumerate(tensors):
        if is_sharded(t):
            groups.setdefault(shard_group(t), []).append(i)
    for group, idx in groups.items():
        part = torch.stack([sq[i] for i in idx])
        torch.distributed.all_reduce(part, group=group)
        for i, v in zip(idx, part):
            sq[i] = v
    return sq


class _Optax(torch.optim.Optimizer):
    """One optax chain ending in ``scale_by_learning_rate``: ``STATE`` names
    the per-parameter state, ``init_state`` makes each entry (zeros like
    the parameter; the runners' checkpoints load into it), ``_direction``
    turns the local gradients into the update direction ``u`` in place of
    the state, and ``step`` applies ``p -= lr(count) * u`` shard by shard."""

    STATE: tuple = ()

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))
        self.count = 0  # optax's scale_by_schedule count

    def init_state(self, key: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def _direction(self, group, params, grads, state) -> list:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        lr = None
        for group in self.param_groups:
            params = group["params"]
            if any(p.grad is None for p in params):
                raise ValueError("every parameter needs a gradient (zeros where "
                                 "the forward did not reach it)")
            for p in params:
                if not self.state[p]:
                    self.state[p] = {k: self.init_state(k, p) for k in self.STATE}
            state = {k: [self.state[p][k] for p in params] for k in self.STATE}
            u = self._direction(group, params, [p.grad for p in params], state)
            lr = self._apply(group, locals_(params), u)
        self.count += 1
        return lr

    def _apply(self, group, params, u) -> float:
        lr = _lr(group["lr"], self.count)
        torch._foreach_add_(params, u, alpha=-lr)
        return lr


class AdamW(_Optax):
    """optax.adamw(schedule, b1, b2, eps, weight_decay), eps_root 0."""

    STATE = ("mu", "nu")

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)

    def _direction(self, group, params, grads, state):
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        mu, nu, grads = locals_(state["mu"]), locals_(state["nu"]), locals_(grads)
        t = self.count + 1
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
        den = torch._foreach_div(nu, 1.0 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(mu_hat, den)  # the Adam direction
        if wd:
            torch._foreach_add_(mu_hat, locals_(params), alpha=wd)
        return mu_hat


class Novograd(_Optax):
    """optax.novograd(schedule, b1, b2, eps, weight_decay=...), eps_root 0:
    ``nu`` is a 0-d float32 tensor a parameter (the squared norm of its
    whole gradient, summed over the shard group of a sharded one)."""

    STATE = ("mu", "nu")

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 betas=(0.9, 0.25), eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)

    def init_state(self, key, p):
        return torch.zeros_like(p) if key == "mu" else torch.zeros((), device=p.device)

    def _direction(self, group, params, grads, state):
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        sq = squared_norms(grads)
        first = self.count == 0
        nu = state["nu"]
        for n, s in zip(nu, sq):  # nu = |g|^2, then (1 - b2) |g|^2 + b2 nu
            n.copy_(s if first else (1.0 - b2) * s + b2 * n)
        den = torch._foreach_add(torch._foreach_sqrt(nu), eps)
        mu = locals_(state["mu"])
        u = torch._foreach_div(locals_(grads), den)  # g / (sqrt(nu) + eps) + wd p
        if wd:
            torch._foreach_add_(u, locals_(params), alpha=wd)
        if first:
            torch._foreach_copy_(mu, u)
        else:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, u)
        return mu


class SGD(_Optax):
    """optax.sgd(schedule, momentum or None) after
    add_decayed_weights(weight_decay) (``sgd:53``)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        self.STATE = ("trace",) if momentum else ()
        super().__init__(params, lr, momentum=momentum, weight_decay=weight_decay)

    def _direction(self, group, params, grads, state):
        wd, momentum = group["weight_decay"], group["momentum"]
        u = torch._foreach_add(locals_(grads), locals_(params), alpha=wd) if wd \
            else locals_(grads)
        if not momentum:
            return u
        trace = locals_(state["trace"])  # t = g + momentum t
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, u)
        return trace


class Adadelta(_Optax):
    """optax.adadelta(schedule, rho=0.9, eps=eps)."""

    STATE = ("e_g", "e_x")

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule, rho: float = 0.9,
                 eps: float = 1e-6):
        super().__init__(params, lr, rho=rho, eps=eps)

    def _direction(self, group, params, grads, state):
        rho, eps = group["rho"], group["eps"]
        grads, e_g, e_x = locals_(grads), locals_(state["e_g"]), locals_(state["e_x"])
        torch._foreach_mul_(e_g, rho)  # e_g = (1 - rho) g^2 + rho e_g
        torch._foreach_addcmul_(e_g, grads, grads, value=1.0 - rho)
        u = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        torch._foreach_div_(u, torch._foreach_sqrt(torch._foreach_add(e_g, eps)))
        torch._foreach_mul_(u, grads)
        torch._foreach_mul_(e_x, rho)  # e_x = (1 - rho) u^2 + rho e_x
        torch._foreach_addcmul_(e_x, u, u, value=1.0 - rho)
        return u


class Adamax(_Optax):
    """optax.adamax(schedule, b1, b2, eps)."""

    STATE = ("mu", "nu")

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr, betas=tuple(betas), eps=eps)

    def _direction(self, group, params, grads, state):
        b1, b2 = group["betas"]
        eps = group["eps"]
        grads, mu, nu = locals_(grads), locals_(state["mu"]), locals_(state["nu"])
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        # nu = max(|g| + eps, b2 nu)
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, torch._foreach_add(torch._foreach_abs(grads), eps))
        u = torch._foreach_div(mu, 1.0 - b1 ** (self.count + 1))
        torch._foreach_div_(u, nu)
        return u


class Adagrad(_Optax):
    """optax.adagrad(schedule, initial_accumulator_value=0.1, eps=eps)."""

    STATE = ("sum_of_squares",)

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, lr, initial_accumulator_value=initial_accumulator_value,
                         eps=eps)

    def init_state(self, key, p):
        return torch.full_like(p, self.defaults["initial_accumulator_value"])

    def _direction(self, group, params, grads, state):
        grads, sos = locals_(grads), locals_(state["sum_of_squares"])
        torch._foreach_addcmul_(sos, grads, grads)
        # where(sum > 0, rsqrt(sum + eps), 0) * g
        inv = [torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) for s in sos]
        return torch._foreach_mul(inv, grads)


class Rprop(_Optax):
    """optax.rprop(lr): eta_minus 0.5, eta_plus 1.2, step sizes in [1e-6,
    50] starting at ``lr``, a constant."""

    STATE = ("step_sizes", "prev_updates")

    def __init__(self, params: Iterable[torch.Tensor], lr: float, eta_minus: float = 0.5,
                 eta_plus: float = 1.2, min_step_size: float = 1e-6,
                 max_step_size: float = 50.0):
        if callable(lr):
            raise TypeError("rprop's learning rate is its initial step size: a constant, "
                            "not a schedule (optax.rprop)")
        super().__init__(params, float(lr), eta_minus=eta_minus, eta_plus=eta_plus,
                         min_step_size=min_step_size, max_step_size=max_step_size)

    def init_state(self, key, p):
        return torch.full_like(p, self.defaults["lr"]) if key == "step_sizes" \
            else torch.zeros_like(p)

    def _direction(self, group, params, grads, state):
        out = []
        for g, step, prev in zip(locals_(grads), locals_(state["step_sizes"]),
                                 locals_(state["prev_updates"])):
            sign = g * prev
            grown = torch.where(sign > 0, group["eta_plus"], group["eta_minus"]) * step
            step.copy_(torch.where(sign == 0, step, grown.clamp(group["min_step_size"],
                                                                group["max_step_size"])))
            # optax applies the update its previous call stored (none the
            # first time), then stores this one's
            out.append(torch.where(sign < 0, 0.0, prev))
            prev.copy_(torch.where(sign < 0, 0.0, step * torch.sign(g)))
        return out

    def _apply(self, group, params, u) -> float:
        torch._foreach_sub_(params, u)  # scale(-1), no lr
        return group["lr"]


def _build(name: str, cfg, lr: Schedule, params) -> torch.optim.Optimizer:
    """``_build:63``: the optimizer ``name`` of an optim config with the lr
    schedule ``lr``."""
    b1, b2 = getattr(cfg, "betas", (0.9, 0.999))
    eps = getattr(cfg, "eps", 1e-8)
    wd = getattr(cfg, "weight_decay", 0.0)
    if name in ("adam", "adamw"):
        return AdamW(params, lr, betas=(b1, b2), eps=eps,
                     weight_decay=wd if name == "adamw" else 0.0)
    if name == "novograd":
        return Novograd(params, lr, betas=(b1, b2), eps=eps, weight_decay=wd)
    if name == "sgd":
        return SGD(params, lr, momentum=getattr(cfg, "momentum", 0.0), weight_decay=wd)
    if name == "adadelta":
        return Adadelta(params, lr, eps=eps)
    if name == "adamax":
        return Adamax(params, lr, betas=(b1, b2), eps=eps)
    if name == "adagrad":
        return Adagrad(params, lr, eps=eps)
    if name == "rprop":
        return Rprop(params, lr)
    raise ValueError(f"unknown optimizer '{name}' (have {sorted(OPTIMIZERS)})")


OPTIMIZERS = {
    "adam", "adamw", "novograd", "sgd", "adadelta", "adamax", "adagrad", "rprop",
}


def make_schedule(optim_cfg, total_steps: int, lr_scale: float = 1.0) -> Schedule:
    """The lr schedule of an optim config's ``sched`` (``make_schedule:96``):
    a constant without one."""
    lr = optim_cfg.lr * lr_scale
    sched = getattr(optim_cfg, "sched", None)
    if sched is None:
        return lr
    max_steps = sched.max_steps or total_steps
    warm = sched.warmup_steps or int((sched.warmup_ratio or 0.0) * max_steps)
    name = sched.name
    if name == "PolynomialHoldDecayAnnealing":
        hold = int((sched.hold_ratio or 0.0) * max_steps)
        return polynomial_hold(lr, warm, max_steps, hold, min_lr=sched.min_lr)
    if name in ("CosineAnnealing", None, ""):
        return warmup_cosine(lr, warm, max_steps, sched.min_lr)
    if name == "InverseSquareRootAnnealing":
        return SCHEDULES[name](lr, warm)
    if name == "NoamAnnealing":
        return SCHEDULES[name](lr, getattr(sched, "d_model", 512), warm)
    fn = SCHEDULES.get(name)
    if fn is None:
        raise ValueError(f"unknown schedule '{name}' (have {sorted(SCHEDULES)})")
    return fn(lr, warm, max_steps, sched.min_lr)


def make_optimizer(optim_cfg, params, total_steps: int, lr_scale: float = 1.0):
    """The optimizer and schedule of a structured optim config
    (``make_optimizer:125``); ``lr_scale`` is the expected_gpu_num rule."""
    sched = make_schedule(optim_cfg, total_steps, lr_scale)
    name = getattr(optim_cfg, "name", "adamw") or "adamw"
    return _build(name, optim_cfg, sched, params)


def clip_by_global_norm(grads, max_norm: Optional[float]) -> Optional[torch.Tensor]:
    """g *= min(1, max_norm / (||g|| + 1e-6)) over all of grads, in place
    (``train/spiral.py:210-215``); returns the norm before clipping. No host
    sync: the scale stays on the device. Sharded gradients (FSDP, TP) add
    their squared sums over their shard group; the others are whole on
    every rank."""
    if max_norm is None:
        return None
    grads = list(grads)
    whole = [g for g in grads if not is_sharded(g)]
    sharded = [g for g in grads if is_sharded(g)]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(whole))) if whole else 0.0
    if sharded:
        norm = torch.sqrt(norm ** 2 + torch.stack(squared_norms(sharded)).sum())
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(whole + locals_(sharded), scale)
    return norm


def clip_subtree_by_global_norm(named_params, prefixes, max_norm: float) -> torch.Tensor:
    """Clip the gradients of the parameters whose names start with one of
    ``prefixes`` (``"encoder."``, ``"decoder.estimator."``) to their joint
    global norm, in place, as ``clip_by_global_norm`` does; the others are
    left as they are. Returns the norm before clipping."""
    grads = [p.grad for name, p in named_params if name.startswith(tuple(prefixes))]
    return clip_by_global_norm(grads, max_norm)


def lr_scale(model_cfg, data_parallel: int = 1, accum: int = 1) -> float:
    """Rescale the config lr for the actual effective batch
    (``spiral_runner.py::_lr_scale:55``)."""
    expected = getattr(model_cfg, "expected_gpu_num", 0) or 0
    if expected <= 0:
        return 1.0
    return float(data_parallel * accum) / float(expected)
