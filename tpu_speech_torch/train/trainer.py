"""What the port's epoch trainers share (Grad-TTS's and DiffVC's two stages).

``Trainer`` owns the model on its training device, its Adam (``AdamW`` with
``weight_decay = 0``, which is ``optax.adam`` step for step), the
checkpoints (``utils/checkpoint.py``: the model, Adam's moments by parameter
name and its count, the step, and the state of torch's default generator and
the card's, which dropout draws from), ``resume_if_exists`` and the final
reference-named ``state_dict``. ``step_generator`` is the counterpart of the
JAX trainers' ``fold_in(base_rng, iteration)``: a step's draws depend on
(seed, iteration) alone, so a resumed run draws what a straight run would.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_speech_torch.train.optim import AdamW
from tpu_speech_torch.utils.checkpoint import Checkpointer
from tpu_speech_torch.utils.profiling import StepTimer


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of one step's draws, on ``device``, seeded from (seed,
    iteration)."""
    return torch.Generator(device).manual_seed((seed << 32) + iteration)


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch of a collate -> tensors on ``device`` (through pinned
    memory for a CUDA device)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def optimizer_state(model: torch.nn.Module, opt: AdamW) -> dict:
    """An ``AdamW``'s moments by parameter name, and its count."""
    names = {p: n for n, p in model.named_parameters()}
    st = opt.state
    return {"mu": {names[p]: s["mu"] for p, s in st.items()},
            "nu": {names[p]: s["nu"] for p, s in st.items()}, "count": opt.count}


def load_optimizer_state(model: torch.nn.Module, opt: AdamW, state: dict) -> None:
    """The inverse of ``optimizer_state``: the moments onto the parameters'
    devices."""
    for name, p in model.named_parameters():
        if name in state["mu"]:
            opt.state[p] = {"mu": state["mu"][name].to(p.device),
                            "nu": state["nu"][name].to(p.device)}
    opt.count = int(state["count"])


class Trainer:
    def __init__(self, model: torch.nn.Module, log_dir: str, learning_rate: float,
                 save_every: int = 1, seed: int = 0, exp=None):
        """model: on its training device. exp: an optional
        ``utils/exp_manager.py::ExpManager`` that owns the log dir and the
        TensorBoard writer."""
        self.model = model
        self.device = next(model.parameters()).device
        self.exp = exp
        self.log_dir = exp.log_dir if exp is not None else log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.opt = AdamW(model.parameters(), learning_rate)
        self.seed = seed
        self.ckpt = Checkpointer(os.path.join(self.log_dir, "ckpt"))
        self.save_every = save_every
        self.tb = exp.tb if exp is not None else None
        self.timer = StepTimer()
        self.iteration = 0

    def state(self) -> dict:
        """What a checkpoint holds: the model's state_dict, Adam's moments
        (by parameter name) and count, the step, and the state of torch's
        default generator (and the device's, on a card), which dropout
        draws from."""
        out = {"model": self.model.state_dict(), **optimizer_state(self.model, self.opt),
               "step": self.iteration, "rng_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            out["rng_cuda"] = torch.cuda.get_rng_state(self.device)
        return out

    def load_state(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        load_optimizer_state(self.model, self.opt, state)
        self.iteration = int(state["step"])
        torch.set_rng_state(state["rng_cpu"])
        if self.device.type == "cuda" and "rng_cuda" in state:
            torch.cuda.set_rng_state(state["rng_cuda"], self.device)

    def resume_if_exists(self) -> bool:
        state = self.ckpt.restore_latest()
        if state is None:
            return False
        self.load_state(state)
        return True

    def save_state_dict(self, name: str) -> str:
        """The final weights, reference-named, as ``<log_dir>/<name>.pt``."""
        path = os.path.join(self.log_dir, f"{name}.pt")
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, path)
        return path
