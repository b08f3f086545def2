"""Multi-process bootstrap over ``torch.distributed``: one process a card.

The port's counterpart of ``tpu_speech/parallel/distributed.py``. The
reference distributes SPIRAL with PyTorch-Lightning DDP, driven by the
environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / NODE_RANK,
SPIRAL/README.md:36-42), over NCCL. ``initialize`` reads the same surface,
and the variables ``torchrun`` sets (RANK, LOCAL_RANK, LOCAL_WORLD_SIZE):

  coordinator  explicit ``host:port``, else MASTER_ADDR:MASTER_PORT (12355)
  world size   explicit, else WORLD_SIZE, else 1
  rank         explicit, else RANK, else NODE_RANK, else 0
  local rank   LOCAL_RANK, else rank % LOCAL_WORLD_SIZE, else 0

The backend is NCCL for a CUDA device and gloo for the CPU; each rank binds
``cuda:<local rank>`` before anything is allocated there. Without a process
group (or at world 1) every collective here is the identity and makes no
call, so a one-process run is the run it was before.

A mesh with a ``model`` axis (``mesh.make_mesh(model_parallel=M)``) gives a
rank M - 1 partners that hold the same rows and frames. The batch's sums
(loss counts, metrics, BatchNorm's moments, the replicated gradients) then
run over the rank's batch group, the ranks of its model coordinate
(``batch_all_reduce_``), and its rows are those of its data coordinate
(``data_coordinate``); ``make_mesh`` records both (``set_batch_layout``) and
``shutdown`` forgets them. Without a model axis the batch group is the
world.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_PORT = "12355"
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
_device: Optional[torch.device] = None  # the rank's device, set by initialize
# (batch group, its size, data index, data size) of a mesh with a model axis
_batch_layout: Optional[tuple] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name, "")
    return int(value) if value else None


def _first(*values):
    return next((v for v in values if v is not None), None)


def rendezvous(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> dict:
    """What ``initialize`` would join: the coordinator (``host:port`` or
    None), the world size, this process's rank and its local rank."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = os.environ["MASTER_ADDR"]
    if coordinator_address and ":" not in coordinator_address:
        coordinator_address += ":" + (os.environ.get("MASTER_PORT") or DEFAULT_PORT)
    world = _first(num_processes, _env_int("WORLD_SIZE"), 1)
    rank = _first(process_id, _env_int("RANK"), _env_int("NODE_RANK"), 0)
    local_world = _env_int("LOCAL_WORLD_SIZE")
    local_rank = _first(_env_int("LOCAL_RANK"), rank % local_world if local_world else None, 0)
    return {"coordinator": coordinator_address or None, "world": world, "rank": rank,
            "local_rank": local_rank}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda",
               init_method: Optional[str] = None) -> None:
    """Idempotent ``torch.distributed.init_process_group`` with the
    environment as fallback (see the module docstring). ``init_method``
    (e.g. a ``file://`` store) replaces the coordinator's ``tcp://``; a
    world of one with neither joins an in-memory store, which contacts
    nothing."""
    global _device
    if is_initialized():
        return
    rv = rendezvous(coordinator_address, num_processes, process_id)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rv["local_rank"])
        dev = torch.device("cuda", rv["local_rank"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = dict(backend=backend, world_size=rv["world"], rank=rv["rank"])
    if init_method is None and rv["coordinator"] is None:
        if rv["world"] > 1:
            raise RuntimeError(f"a world of {rv['world']} processes needs a coordinator: "
                               "set MASTER_ADDR/MASTER_PORT (or --master_addr)")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method or f"tcp://{rv['coordinator']}"
    dist.init_process_group(**kw)
    _device = dev


def shutdown() -> None:
    global _device, _batch_layout
    if is_initialized():
        dist.destroy_process_group()
    _device = None
    _batch_layout = None


def set_batch_layout(layout: Optional[tuple]) -> None:
    """(the batch group, its size, this rank's data index, the data size),
    or None for the world (no model axis); ``mesh.make_mesh`` sets it."""
    global _batch_layout
    _batch_layout = layout


def batch_count() -> int:
    """The ranks that hold different rows or frames of the global batch:
    the batch group's size (the world without a model axis)."""
    return process_count() if _batch_layout is None else _batch_layout[1]


def data_coordinate() -> tuple:
    """(this rank's data index, the data size): the rows it holds are those
    of its index (rank and world without a model axis)."""
    if _batch_layout is None:
        return process_index(), process_count()
    return _batch_layout[2], _batch_layout[3]


def batch_all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``all_reduce_`` over the batch group: each rank's piece counted once
    however many model partners hold it."""
    if batch_count() > 1:
        group = None if _batch_layout is None else _batch_layout[0]
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint side effects."""
    return process_index() == 0


def device() -> Optional[torch.device]:
    """The device ``initialize`` bound this rank to (None before)."""
    return _device


def rank_device(dev: torch.device) -> torch.device:
    """``cuda`` (no index) as this rank's card once ``initialize`` bound
    one; any other device as it is."""
    if dev.type == "cuda" and dev.index is None and _device is not None \
            and _device.type == "cuda":
        return _device
    return dev


def _collective_device(like: Optional[torch.Tensor] = None) -> torch.device:
    """Where a collective's tensor lives: NCCL takes the rank's card, gloo
    the CPU (or the caller's tensor's device)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return like.device if like is not None else torch.device("cpu")


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of a tensor (``sum``, ``min`` or ``max``); the
    identity at world 1."""
    if process_count() > 1:
        dist.all_reduce(t, op=_OPS[op])
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    if process_count() > 1:
        dist.broadcast(t, src)
    return t


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def allreduce_sum(x) -> np.ndarray:
    """Element-wise sum of a small host array across processes, exact
    (integers as int64); the identity in a one-process run. The global
    metric reduction after per-process evaluation shards (the reference's
    dist_sync_on_step WER reduction, ctc_finetune.py:119)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    host = x.astype(np.int64) if np.issubdtype(x.dtype, np.integer) else x.astype(np.float64)
    t = torch.from_numpy(np.ascontiguousarray(host)).to(_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def require_multiprocess(num_nodes: int) -> None:
    """Fail loudly if a multi-node launch was not actually federated (the
    reference's Lightning falls back silently; a --num_nodes flag that does
    nothing is worse than none)."""
    if num_nodes > 1 and process_count() < num_nodes:
        raise RuntimeError(
            f"--num_nodes={num_nodes} but only {process_count()} "
            "process(es) federated. Set MASTER_ADDR/MASTER_PORT/"
            "WORLD_SIZE/NODE_RANK so that distributed.initialize can "
            "connect the hosts."
        )
