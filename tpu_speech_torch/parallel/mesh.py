"""The data axis: batch slicing, replication, gradient all-reduce and FSDP.

The port's counterpart of ``tpu_speech/parallel/mesh.py``. The reference's
only parallelism is data-parallel DDP over NCCL (SPIRAL/README.md:36-42). In
JAX one program sees the global batch sharded over the ``data`` axis of a
mesh; here each rank runs the step on its contiguous slice of that batch
(``shard_batch``) and the gradients are summed across ranks
(``allreduce_grads``), which gives the same update once every loss divides
its local sum by the GLOBAL count (the steps all-reduce the counts first).

FSDP (``--fsdp``, ``fsdp_shardings:146``): each parameter is split along its
largest dimension that the data size divides; parameters under 2**14
elements stay replicated, as JAX leaves them. ``shard_state_fsdp`` applies
the rule through FSDP2's ``fully_shard`` with the replicated ones as
``ignored_params`` (their gradients go through ``allreduce_grads``).

The ``seq`` axis (``make_mesh(seq_parallel=S)``, ``mesh.py:23-53``) makes
the mesh (data, seq) of world / S by S ranks, rank r at (r // S, r % S) as
JAX lays its devices out: the batch is sharded over ``data`` alone and a
data group's S ranks split the encoders' time axis (``parallel/seq.py``).
The ``model`` axis (TP placement) is not ported yet: ``make_mesh`` stops
naming its ROADMAP item.

The trainers' draws (crop offsets, diffusion times and noise) are made at
the global batch's shape and sliced to the rank's rows (``global_rows``),
so N ranks draw what one process draws on the whole batch.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from tpu_speech_torch.parallel import distributed

DATA_AXIS = "data"
SEQ_AXIS = "seq"
REPLICATED = "replicated"
# the ROADMAP Queue 1 item that ports the model axis
NEXT_ITEM = ("11.3", "TP placement, shard_params_tp")
BUCKET_BYTES = 64 << 20  # gradient all-reduce bucket
MIN_SIZE = 2 ** 14  # FSDP leaves under this many elements stay replicated


def make_mesh(n_devices: Optional[int] = None, seq_parallel: int = 1,
              model_parallel: int = 1, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the process group (one card a
    rank; ``n_devices`` must equal the world size): 1-D ``data``, or with
    ``seq_parallel`` S > 1 the 2-D (data, seq) of world / S by S. A
    ``model`` axis above 1 stops the run."""
    if model_parallel > 1:
        raise SystemExit(f"model_parallel={model_parallel}: not ported yet, ROADMAP.md "
                         f"Queue 1 item {NEXT_ITEM[0]} ({NEXT_ITEM[1]})")
    if not distributed.is_initialized():
        raise RuntimeError("make_mesh needs distributed.initialize first")
    world = distributed.process_count()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}: the mesh has one rank a card, "
                         f"and this process group has {world}")
    sp = max(1, seq_parallel)
    if world % sp:
        raise ValueError(f"seq_parallel={sp} does not divide the {world} ranks of this "
                         "process group")
    from torch.distributed.device_mesh import init_device_mesh

    dev = distributed.device()
    device_type = device_type or (dev.type if dev is not None else "cpu")
    if sp == 1:
        return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA_AXIS,))
    return init_device_mesh(device_type, (world // sp, sp), mesh_dim_names=(DATA_AXIS, SEQ_AXIS))


def data_axis(mesh) -> tuple:
    """(this rank's index on the data axis, its size): (rank, world) on a
    1-D mesh or without one."""
    if mesh is None:
        return distributed.process_index(), distributed.process_count()
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def seq_size(mesh) -> int:
    """The seq axis's size (1 without one)."""
    if mesh is None or SEQ_AXIS not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(SEQ_AXIS))


def global_rows(n_local: int, rank: Optional[int] = None,
                world: Optional[int] = None) -> tuple:
    """(the global batch, this rank's rows as a slice) of a rank batch of
    ``n_local``: a draw of the global shape sliced by it is this rank's
    share of the one-process draw."""
    rank, world = _rank_world(rank, world)
    return n_local * world, slice(rank * n_local, (rank + 1) * n_local)


def global_count(local: torch.Tensor) -> torch.Tensor:
    """The sum of ``local`` (a 0-d count) over the ranks, at least 1, in its
    dtype: the global denominator of a loss."""
    total = distributed.all_reduce_(local.detach().float())
    return torch.clamp(total, min=1.0).to(local.dtype)


def global_counts(*local: torch.Tensor) -> Optional[list]:
    """0-d counts summed over the ranks in one call, in float32; None at
    world 1 (the losses then divide by their own sums, as before)."""
    if distributed.process_count() == 1:
        return None
    return list(distributed.all_reduce_(torch.stack([c.detach().float() for c in local])))


def global_metrics(*values: torch.Tensor) -> list:
    """0-d tensors summed over the ranks in one call (each rank's piece of a
    global mean); as they are at world 1."""
    if distributed.process_count() == 1:
        return list(values)
    return list(distributed.all_reduce_(torch.stack([v.detach().float() for v in values])))


def _rank_world(rank, world):
    return (distributed.process_index() if rank is None else rank,
            distributed.process_count() if world is None else world)


def _rows(n: int, rank: int, world: int) -> slice:
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: dict, rank: Optional[int] = None, world: Optional[int] = None) -> dict:
    """This rank's contiguous slice of a host batch along axis 0; rank-0
    leaves (per-step scalars) are replicated (``shard_batch:65``)."""
    rank, world = _rank_world(rank, world)
    return {k: v if np.ndim(v) == 0 else v[_rows(len(v), rank, world)]
            for k, v in batch.items()}


def shard_microbatches(batch: dict, rank: Optional[int] = None,
                       world: Optional[int] = None) -> dict:
    """Stacked micro-batches ``[n_micro, batch, ...]``: this rank's slice of
    axis 1; rank-1 leaves (stacked per-step scalars) are replicated
    (``shard_microbatches:91``)."""
    rank, world = _rank_world(rank, world)
    return {k: v if np.ndim(v) <= 1 else v[:, _rows(v.shape[1], rank, world)]
            for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` as rank 0 has it
    (``replicate:115``); nothing happens at world 1."""
    if distributed.process_count() > 1:
        for t in [*module.parameters(), *module.buffers()]:
            if not is_sharded(t):
                distributed.broadcast_(t.data)
    return module


# ---- FSDP -------------------------------------------------------------------

def fsdp_shardings(mesh, named_params, min_size: Optional[int] = None) -> dict:
    """``{name: Shard(dim) or REPLICATED}`` for (name, tensor) pairs by the
    rule of ``fsdp_shardings:146``: the largest dimension the data size
    divides (the first of equal ones); replicated under ``min_size``
    elements or where no dimension divides. ``mesh`` is a ``DeviceMesh`` or
    the data size."""
    from torch.distributed.tensor import Shard

    size = mesh if isinstance(mesh, int) else mesh.size()
    min_size = MIN_SIZE if min_size is None else min_size
    out = {}
    for name, t in named_params:
        shape = tuple(t.shape)
        best_dim, best = -1, 0
        if shape and int(np.prod(shape)) >= min_size:
            for i, d in enumerate(shape):
                if d % size == 0 and d > best:
                    best_dim, best = i, d
        out[name] = Shard(best_dim) if best_dim >= 0 else REPLICATED
    return out


def shard_state_fsdp(mesh, module: torch.nn.Module, min_size: Optional[int] = None,
                     bf16: bool = False) -> list:
    """Shard ``module``'s parameters in place with FSDP2's ``fully_shard``
    by ``fsdp_shardings``; returns the replicated ones, which FSDP leaves
    alone. Call it before the optimizer is built. Gradients are summed over
    the ranks, not averaged (the losses divide by the global count).
    ``bf16`` gathers bf16 copies of the float32 shards for the forward and
    reduces the gradients in float32 (``MixedPrecisionPolicy``); the
    replicated parameters stay float32 and the step casts them itself."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    plan = fsdp_shardings(mesh, module.named_parameters(), min_size)
    params = dict(module.named_parameters())
    by_id = {id(params[n]): s for n, s in plan.items()}
    replicated = [params[n] for n, s in plan.items() if s == REPLICATED]
    policy = (MixedPrecisionPolicy(param_dtype=torch.bfloat16, reduce_dtype=torch.float32)
              if bf16 else MixedPrecisionPolicy())
    # resharded after every forward, the root's too: a forward that no
    # backward follows (validation, serving) leaves the shards registered
    fully_shard(module, mesh=mesh, reshard_after_forward=True,
                shard_placement_fn=lambda p: by_id[id(p)],
                ignored_params=set(replicated), mp_policy=policy)
    module.set_gradient_divide_factor(1.0)
    # a plain SUM (gloo has no PREMUL_SUM, which a factor would otherwise pick)
    module.set_force_sum_reduction_for_comms(True)
    return replicated


def is_sharded(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (which aliases it); others as they are."""
    return t.to_local() if is_sharded(t) else t


def locals_(tensors: Iterable[torch.Tensor]) -> list:
    return [local(t) for t in tensors]


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor gathered whole on every rank (a collective: every
    rank calls it); others as they are."""
    return t.full_tensor() if is_sharded(t) else t


@torch.no_grad()
def load_full_(t: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a whole tensor into ``t``; a sharded ``t`` takes its own rank's
    chunk (no collective)."""
    if is_sharded(t):
        dim = t.placements[0].dim
        full = full.chunk(t.device_mesh.size(), dim)[t.device_mesh.get_local_rank()]
    local(t).copy_(full)


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` with every sharded tensor gathered whole (a
    collective under FSDP: every rank calls it)."""
    return {k: full_tensor(v) for k, v in module.state_dict().items()}


@torch.no_grad()
def load_state_dict_(module: torch.nn.Module, state_dict) -> None:
    """A strict ``load_state_dict`` of whole tensors; a sharded module takes
    each rank's chunks (``load_full_``)."""
    if not any(is_sharded(p) for p in module.parameters()):
        module.load_state_dict(state_dict, strict=True)
        return
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    keys = set(module.state_dict())
    if keys != set(state_dict):
        raise KeyError(f"state_dict mismatch: missing {sorted(keys - set(state_dict))}, "
                       f"unexpected {sorted(set(state_dict) - keys)}")
    for k in keys:
        load_full_(own[k], state_dict[k])


def allreduce_grads(params: Iterable[torch.Tensor]) -> int:
    """Sum the gradients of the replicated ``params`` over the ranks, in
    flat buckets of ``BUCKET_BYTES`` (one collective each), in place;
    sharded ones (FSDP reduce-scatters them) are skipped. Returns the bytes
    reduced (0 at world 1, where nothing is called)."""
    if distributed.process_count() == 1:
        return 0
    grads = [p.grad for p in params if p.grad is not None and not is_sharded(p)]
    total, bucket, size = 0, [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        distributed.all_reduce_(flat)
        parts = flat.split([g.numel() for g in bucket])
        torch._foreach_copy_(bucket, [p.view_as(g) for p, g in zip(parts, bucket)])
        return flat.numel() * flat.element_size()

    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype or size + g.numel() * g.element_size()
                       > BUCKET_BYTES):
            total += flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        total += flush()
    return total
