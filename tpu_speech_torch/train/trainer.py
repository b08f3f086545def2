"""What the port's epoch trainers share (Grad-TTS's and DiffVC's two stages).

``Trainer`` owns the model on its training device, its Adam (``AdamW`` with
``weight_decay = 0``, which is ``optax.adam`` step for step), the
checkpoints (``utils/checkpoint.py``: the model, Adam's moments by parameter
name and its count, the step, and the state of torch's default generator and
the card's, which dropout draws from), ``resume_if_exists`` and the final
reference-named ``state_dict``. ``step_generator`` is the counterpart of the
JAX trainers' ``fold_in(base_rng, iteration)``: a step's draws depend on
(seed, iteration) alone, so a resumed run draws what a straight run would.

Over N ranks (one process a card, ``parallel/launch.py``) the trainers run
JAX's mesh step: ``params.batch_size`` is the global batch, each rank takes
its contiguous rows of it (``shard``), every draw is made at the global
shape and sliced to the rank's rows (``parallel/mesh.py::global_rows``), the
losses divide by global counts, and the gradients are summed over the ranks
(``allreduce_grads``) before any clip. ``step_generator`` is common to the
ranks; torch's default generator, which dropout draws from, is seeded apart
on ranks 1..N-1 (rank 0 keeps the one-process stream). Rank 0 alone writes
``train.log``, TensorBoard, checkpoints, previews and the final ``.pt``; a
checkpoint holds every rank's generators under ``ranks``, and every rank
resumes from it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_speech_torch.parallel import distributed
from tpu_speech_torch.parallel.mesh import replicate, shard_batch
from tpu_speech_torch.train.optim import AdamW
from tpu_speech_torch.utils.checkpoint import Checkpointer
from tpu_speech_torch.utils.profiling import StepTimer


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of one step's draws, on ``device``, seeded from (seed,
    iteration)."""
    return torch.Generator(device).manual_seed((seed << 32) + iteration)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s default generator (dropout's): ``seed``
    on rank 0, as a one-process run; apart on the others (the spread of
    ``models/spiral/dropout.py::DropoutRng.seeded``)."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B9) % 2**32


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
        self.rank, self.world = distributed.process_index(), distributed.process_count()
        self.primary = self.rank == 0
        if self.world > 1:
            replicate(model)  # rank 0's weights
            torch.manual_seed(rank_seed(seed, self.rank))
        self.exp = exp
        self.log_dir = exp.log_dir if exp is not None else log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.opt = AdamW(model.parameters(), learning_rate)
        self.seed = seed
        self.ckpt = Checkpointer(os.path.join(self.log_dir, "ckpt"))
        self.save_every = save_every
        self.tb = exp.tb if exp is not None and self.primary else None
        self.timer = StepTimer()
        self.iteration = 0

    def shard(self, batch: dict) -> dict:
        """This rank's contiguous rows of a global host batch (all of it in
        a one-process run)."""
        return shard_batch(batch, self.rank, self.world) if self.world > 1 else batch

    def _rng_state(self) -> dict:
        out = {"rng_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            out["rng_cuda"] = torch.cuda.get_rng_state(self.device)
        return out

    def state(self) -> dict:
        """What a checkpoint holds: the model's state_dict, Adam's moments
        (by parameter name) and count, the step, and the state of torch's
        default generator (and the device's, on a card), which dropout
        draws from; over N ranks every rank's generators under ``ranks``
        (every rank calls this)."""
        out = {"model": self.model.state_dict(), **optimizer_state(self.model, self.opt),
               "step": self.iteration, **self._rng_state()}
        if self.world > 1:
            out["ranks"] = [None] * self.world
            torch.distributed.all_gather_object(out["ranks"], self._rng_state())
        return out

    def load_state(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        load_optimizer_state(self.model, self.opt, state)
        self.iteration = int(state["step"])
        ranks = state.get("ranks") or [state]
        if len(ranks) != self.world and self.rank > 0:
            return  # a file of another world: ranks 1..N-1 keep their fresh generators
        rng = ranks[self.rank] if len(ranks) == self.world else state
        torch.set_rng_state(rng["rng_cpu"])
        if self.device.type == "cuda" and "rng_cuda" in rng:
            torch.cuda.set_rng_state(rng["rng_cuda"], self.device)

    def save_checkpoint(self) -> None:
        """A step checkpoint, written by rank 0 (every rank calls this)."""
        state = self.state()
        if self.primary:
            self.ckpt.save(self.iteration, state)

    def resume_if_exists(self) -> bool:
        state = self.ckpt.restore_latest()
        if state is None:
            return False
        self.load_state(state)
        return True

    def save_state_dict(self, name: str) -> str:
        """The final weights, reference-named, as ``<log_dir>/<name>.pt``
        (written by rank 0; every rank returns the path)."""
        path = os.path.join(self.log_dir, f"{name}.pt")
        if self.primary:
            torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, path)
        distributed.barrier()
        return path
