"""The mesh: batch slicing, replication, gradient all-reduce, FSDP and TP.

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

The ``seq`` and ``model`` axes (``make_mesh(seq_parallel=S,
model_parallel=M)``, ``mesh.py:23-53``) make the mesh (data, seq, model),
the axes of size 1 but ``data`` left out, rank r at (r // (S M), (r // M) %
S, r % M) as JAX lays its devices out. The batch is sharded over ``data``
alone: a data group's S ranks split the encoders' time axis
(``parallel/seq.py``) and its M model ranks hold the same rows and frames.
So under a model axis the batch's sums run over the ranks of one model
coordinate (``distributed.batch_all_reduce_``) and a rank's rows are its
data coordinate's (``distributed.data_coordinate``): ``make_mesh`` records
both. ``shard_params_tp`` is JAX's TP placement (``shard_params_tp:190``):
each parameter whose flax leaf has rank >= 2 and a last axis that M divides
is split along it over ``model`` (``compat/flax_layout.py`` finds that axis
in the torch layout), through FSDP2 on the (batch, model) mesh; the step's
math is the unsharded one, as XLA's placement leaves it. The M ranks of a
model group compute the same gradients: the sharded ones' sum over them is
divided by M, and the replicated ones are summed over the world and
divided by M (``allreduce_grads``), which keeps the M copies equal.

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
MODEL_AXIS = "model"
BATCH_AXIS = "batch"  # the ranks of one model coordinate (data x seq), flattened
REPLICATED = "replicated"
BUCKET_BYTES = 64 << 20  # gradient all-reduce bucket
MIN_SIZE = 2 ** 14  # FSDP leaves under this many elements stay replicated


def make_mesh(n_devices: Optional[int] = None, seq_parallel: int = 1,
              model_parallel: int = 1, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the process group (one card a
    rank; ``n_devices`` must equal the world size): (data, seq, model) of
    world / (S M) by S by M, the axes of size 1 but ``data`` left out.
    Records the batch layout of a model axis (``distributed.set_batch_layout``;
    cleared without one)."""
    if not distributed.is_initialized():
        raise RuntimeError("make_mesh needs distributed.initialize first")
    world = distributed.process_count()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}: the mesh has one rank a card, "
                         f"and this process group has {world}")
    sp, mp = max(1, seq_parallel), max(1, model_parallel)
    if world % sp:
        raise ValueError(f"seq_parallel={sp} does not divide the {world} ranks of this "
                         "process group")
    if world % (sp * mp):
        raise ValueError(f"model_parallel={mp} x seq_parallel={sp} does not divide the "
                         f"{world} ranks of this process group")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or _device_type()
    shape, names = mesh_layout(world, sp, mp)
    layout = None
    if mp > 1:
        rank = distributed.process_index()
        group = _batch_model_mesh(world, mp, device_type).get_group(BATCH_AXIS)
        layout = (group, world // mp, rank // (sp * mp), world // (sp * mp))
    distributed.set_batch_layout(layout)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_layout(world: int, seq_parallel: int = 1, model_parallel: int = 1) -> tuple:
    """(shape, axis names) of ``make_mesh``'s mesh over ``world`` ranks:
    ``data`` first, then ``seq`` and ``model`` where above 1 (rank r sits
    at ``np.arange(world).reshape(shape)``'s position of r, as JAX reshapes
    its device list)."""
    shape, names = [world // (seq_parallel * model_parallel)], [DATA_AXIS]
    for size, name in ((seq_parallel, SEQ_AXIS), (model_parallel, MODEL_AXIS)):
        if size > 1:
            shape.append(size)
            names.append(name)
    return tuple(shape), tuple(names)


def _device_type() -> str:
    dev = distributed.device()
    return dev.type if dev is not None else "cpu"


def _batch_model_mesh(world: int, mp: int, device_type: str):
    """The 2-D (batch, model) mesh of a model axis of ``mp``: a column is
    the ranks of one model coordinate, a row one data (x seq) position's
    model group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (world // mp, mp),
                            mesh_dim_names=(BATCH_AXIS, MODEL_AXIS))


def data_axis(mesh) -> tuple:
    """(this rank's index on the data axis, its size): (rank, world) on a
    1-D mesh or without one."""
    if mesh is None:
        return distributed.process_index(), distributed.process_count()
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def _axis_size(mesh, name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def model_size(mesh) -> int:
    """The model axis's size (1 without one)."""
    return _axis_size(mesh, MODEL_AXIS)


def seq_size(mesh) -> int:
    """The seq axis's size (1 without one)."""
    return _axis_size(mesh, SEQ_AXIS)


def global_rows(n_local: int, rank: Optional[int] = None,
                world: Optional[int] = None) -> tuple:
    """(the global batch, this rank's rows as a slice) of a rank batch of
    ``n_local``: a draw of the global shape sliced by it is this rank's
    share of the one-process draw. By default the rank's data coordinate
    (``distributed.data_coordinate``)."""
    rank, world = _rank_world(rank, world)
    return n_local * world, slice(rank * n_local, (rank + 1) * n_local)


def global_count(local: torch.Tensor) -> torch.Tensor:
    """The sum of ``local`` (a 0-d count) over the batch group, at least 1,
    in its dtype: the global denominator of a loss."""
    total = distributed.batch_all_reduce_(local.detach().float())
    return torch.clamp(total, min=1.0).to(local.dtype)


def global_counts(*local: torch.Tensor) -> Optional[list]:
    """0-d counts summed over the batch group in one call, in float32; None
    for a group of one (the losses then divide by their own sums, as
    before)."""
    if distributed.batch_count() == 1:
        return None
    return list(distributed.batch_all_reduce_(torch.stack([c.detach().float()
                                                           for c in local])))


def global_metrics(*values: torch.Tensor) -> list:
    """0-d tensors summed over the batch group in one call (each rank's
    piece of a global mean); as they are for a group of one."""
    if distributed.batch_count() == 1:
        return list(values)
    return list(distributed.batch_all_reduce_(torch.stack([v.detach().float()
                                                           for v in values])))


def _rank_world(rank, world):
    index, size = distributed.data_coordinate()
    return index if rank is None else rank, size if world is None else world


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
    plan = fsdp_shardings(mesh, module.named_parameters(), min_size)
    return _fully_shard(module, mesh, plan, bf16, divide=1.0)


def tp_shardings(model_parallel: int, module: torch.nn.Module) -> dict:
    """``{name: Shard(dim) or REPLICATED}`` for ``module``'s parameters by
    the rule of ``shard_params_tp:190``: split along the flax leaf's last
    axis (``compat/flax_layout.py``) where that leaf has rank >= 2 and the
    axis is at least ``model_parallel`` and a multiple of it; no minimum
    size."""
    from torch.distributed.tensor import Shard

    from tpu_speech_torch.compat.flax_layout import feature_dims

    dims = feature_dims(module)
    out = {}
    for name, p in module.named_parameters():
        d = dims[name]
        size = p.shape[d] if d is not None else 0
        out[name] = (Shard(d) if d is not None and size >= model_parallel
                     and size % model_parallel == 0 else REPLICATED)
    return out


def shard_params_tp(mesh, module: torch.nn.Module, bf16: bool = False) -> list:
    """JAX's tensor-parallel placement over the ``model`` axis of ``mesh``
    (``shard_params_tp:190``), in place, before the optimizer is built (its
    moments then follow their parameter, as JAX maps the rule over the
    whole state): ``tp_shardings``' parameters are split over the model
    ranks through FSDP2 on the (batch, model) mesh, gathered whole before
    each forward; the others are replicated (their gradients go through
    ``allreduce_grads``). The model ranks compute the same gradients, so
    the reduce-scatter's sum over them is divided by M; the batch group's
    are summed. Returns the replicated parameters."""
    mp = model_size(mesh)
    if mp == 1:
        raise ValueError("shard_params_tp needs a mesh with a model axis")
    plan = tp_shardings(mp, module)
    world = distributed.process_count()
    tp_mesh = _batch_model_mesh(world, mp, mesh.device_type)
    return _fully_shard(module, tp_mesh, plan, bf16, divide=float(mp))


def _fully_shard(module, mesh, plan: dict, bf16: bool, divide: float) -> list:
    """``fully_shard`` of ``module`` over ``mesh`` (1-D: FSDP; 2-D:
    replicated over dim 0, sharded over dim 1) by ``plan``; gradients
    reduced by plain sums and divided by ``divide``."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

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
    module.set_gradient_divide_factor(divide)
    # a plain SUM (gloo has no PREMUL_SUM, which a factor would otherwise pick)
    module.set_force_sum_reduction_for_comms(True)
    if distributed.is_initialized() and torch.distributed.get_backend() == "gloo":
        all_gather, reduce_scatter = _host_comms()
        module.set_custom_all_gather(all_gather)
        module.set_custom_reduce_scatter(reduce_scatter)
    return replicated


def _host_comms():
    """FSDP2's all-gather and reduce-scatter for gloo (ranks on the CPU, or
    sharing a card in the checks): each through host copies and gloo's
    list all-gather and all-reduce. FSDP2's own collectives over gloo with
    CUDA tensors killed a rank (SIGSEGV, torch 2.11), though each flat
    collective alone ran."""
    import torch.distributed as dist
    from torch.distributed.fsdp._fully_shard._fsdp_api import AllGather, ReduceScatter

    class _Alloc:
        def allocate(self, size, *, dtype, device):
            return torch.empty(*size, dtype=dtype, device=device)

    class HostAllGather(_Alloc, AllGather):
        def __call__(self, output_tensor, input_tensor, group, async_op=False):
            x = input_tensor.cpu()
            parts = [torch.empty_like(x) for _ in range(group.size())]
            dist.all_gather(parts, x, group=group)
            output_tensor.copy_(torch.cat(parts))

    class HostReduceScatter(_Alloc, ReduceScatter):
        def __call__(self, output_tensor, input_tensor, group, op, async_op=False):
            x = input_tensor.to("cpu", copy=True)
            dist.all_reduce(x, op=op, group=group)
            n, r = output_tensor.numel(), group.rank()
            output_tensor.copy_(x[r * n:(r + 1) * n])

    return HostAllGather(), HostReduceScatter()


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
    rank calls it); others as they are. Under gloo each ``Shard`` placement
    is gathered with gloo's list all-gather, as ``_host_comms`` gathers
    (the shards are equal: both rules split only dimensions the group
    divides)."""
    if not is_sharded(t):
        return t
    if torch.distributed.get_backend() != "gloo":
        return t.full_tensor()
    x = t.to_local()
    for mesh_dim, dim in reversed(shard_dims(t)):
        group = t.device_mesh.get_group(mesh_dim)
        parts = [torch.empty_like(x) for _ in range(group.size())]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim)
    return x


def shard_dims(t: torch.Tensor) -> list:
    """(mesh dim, tensor dim) of each ``Shard`` placement of a sharded
    tensor, on a mesh of any rank."""
    from torch.distributed.tensor import Shard

    return [(i, p.dim) for i, p in enumerate(t.placements) if isinstance(p, Shard)]


def shard_group(t: torch.Tensor):
    """The process group over which a sharded tensor's pieces lie (its
    ``Shard`` mesh dim): the world under FSDP, the model ranks under
    ``shard_params_tp``."""
    (mesh_dim, _), = shard_dims(t)
    return t.device_mesh.get_group(mesh_dim)


@torch.no_grad()
def load_full_(t: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a whole tensor into ``t``; a sharded ``t`` takes its own rank's
    chunk of each ``Shard`` placement (no collective)."""
    if is_sharded(t):
        for mesh_dim, dim in shard_dims(t):
            full = full.chunk(t.device_mesh.size(mesh_dim), dim)[
                t.device_mesh.get_local_rank(mesh_dim)]
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
    """Sum the gradients of the replicated ``params`` over the batch group,
    in flat buckets of ``BUCKET_BYTES`` (one collective each), in place;
    sharded ones (FSDP reduce-scatters them) are skipped. Under a model
    axis of M the sum runs over the world and is divided by M: the batch
    group's sum, the same on the M model ranks, whose copies the card's
    unordered sums may leave a rounding apart. Returns the bytes reduced (0
    at world 1, where nothing is called)."""
    if distributed.process_count() == 1:
        return 0
    copies = distributed.process_count() // distributed.batch_count()
    grads = [p.grad for p in params if p.grad is not None and not is_sharded(p)]
    total, bucket, size = 0, [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        distributed.all_reduce_(flat)
        if copies > 1:
            flat.div_(copies)
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
