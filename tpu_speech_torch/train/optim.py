"""Optimizers with optax's semantics, and the global-norm gradient clip.

Port of ``tpu_speech/train/optim.py::make_optimizer:125`` for the optimizers
the SPIRAL recipes use (Grad-TTS's ``optax.adam`` is ``AdamW`` with
``weight_decay = 0``), of the clip in ``train/spiral.py:210-215``, and of
``clip_subtree_by_global_norm:24``, Grad-TTS's per-module clip.

``AdamW`` is ``optax.adamw`` step for step, which ``torch.optim.AdamW`` is
not quite:

- the moments update as ``(1 - b) * g^k + b * m``;
- the bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``: eps outside the sqrt;
- then ``+ weight_decay * p`` on EVERY parameter (no mask: optax decays
  biases and norms too);
- then ``p -= lr(count) * update``, with ``count`` the number of updates
  before this one (the schedule sees 0 on the first step).

The update runs as ``torch._foreach_*`` calls over all parameters (a handful
of launches per step on the card). Every parameter needs a gradient: the
pretrain step fills the ones a forward did not reach with zeros, as JAX
differentiates every leaf.

Under FSDP (``parallel/mesh.py::shard_state_fsdp``) the parameters, their
gradients and the moments of the sharded ones are ``DTensor`` shards: the
update runs on each rank's local shards, as JAX's AdamW runs shard-wise, and
the global-norm clip all-reduces the shards' squared sums, so it clips by
the norm of the whole gradient.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from tpu_speech_torch.parallel import distributed
from tpu_speech_torch.parallel.mesh import is_sharded, locals_
from tpu_speech_torch.train.schedules import polynomial_hold, warmup_cosine

Schedule = Union[float, Callable[[int], float]]


def _lr(schedule: Schedule, count: int) -> float:
    return schedule(count) if callable(schedule) else float(schedule)


class AdamW(torch.optim.Optimizer):
    """optax.adamw(schedule, b1, b2, eps, weight_decay), eps_root 0."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.count = 0  # optax's scale_by_schedule count

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        lr = None
        for group in self.param_groups:
            params = group["params"]
            if any(p.grad is None for p in params):
                raise ValueError("every parameter needs a gradient (zeros where "
                                 "the forward did not reach it)")
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
            mu = locals_(self.state[p]["mu"] for p in params)
            nu = locals_(self.state[p]["nu"] for p in params)
            grads = locals_(p.grad for p in params)
            params = locals_(params)
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
                torch._foreach_add_(mu_hat, params, alpha=wd)
            lr = _lr(group["lr"], self.count)
            torch._foreach_add_(params, mu_hat, alpha=-lr)
        self.count += 1
        return lr


def make_schedule(optim_cfg, total_steps: int, lr_scale: float = 1.0) -> Schedule:
    """The lr schedule of an optim config (``make_schedule:96``) for the
    schedules the SPIRAL recipes name."""
    lr = optim_cfg.lr * lr_scale
    sched = getattr(optim_cfg, "sched", None)
    if sched is None:
        return lr
    max_steps = sched.max_steps or total_steps
    warm = sched.warmup_steps or int((sched.warmup_ratio or 0.0) * max_steps)
    if sched.name == "PolynomialHoldDecayAnnealing":
        hold = int((sched.hold_ratio or 0.0) * max_steps)
        return polynomial_hold(lr, warm, max_steps, hold, min_lr=sched.min_lr)
    if sched.name in ("CosineAnnealing", None, ""):
        return warmup_cosine(lr, warm, max_steps, sched.min_lr)
    raise NotImplementedError(f"schedule {sched.name!r} is not ported yet")


def make_optimizer(optim_cfg, params, total_steps: int, lr_scale: float = 1.0):
    """AdamW + schedule from a structured optim config (``make_optimizer:125``;
    the SPIRAL recipes all use AdamW); ``lr_scale`` is the expected_gpu_num
    rule."""
    sched = make_schedule(optim_cfg, total_steps, lr_scale)
    name = getattr(optim_cfg, "name", "adamw") or "adamw"
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    return AdamW(params, sched, betas=getattr(optim_cfg, "betas", (0.9, 0.999)),
                 eps=getattr(optim_cfg, "eps", 1e-8),
                 weight_decay=getattr(optim_cfg, "weight_decay", 0.0))


def clip_by_global_norm(grads, max_norm: Optional[float]) -> Optional[torch.Tensor]:
    """g *= min(1, max_norm / (||g|| + 1e-6)) over all of grads, in place
    (``train/spiral.py:210-215``); returns the norm before clipping. No host
    sync: the scale stays on the device. Sharded gradients (FSDP) add their
    squared sums over the ranks; the others are whole on every rank."""
    if max_norm is None:
        return None
    grads = list(grads)
    whole = [g for g in grads if not is_sharded(g)]
    shards = locals_(g for g in grads if is_sharded(g))
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(whole))) if whole else 0.0
    if shards:
        sq = torch.stack(torch._foreach_norm(shards)).square().sum()
        norm = torch.sqrt(norm ** 2 + distributed.all_reduce_(sq))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(whole + shards, scale)
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
