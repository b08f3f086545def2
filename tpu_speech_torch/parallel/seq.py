"""The seq axis: the encoders' time axis split over the ranks of a seq group.

The port's counterpart of ``seq_constrainer`` (``tpu_speech/parallel/
mesh.py:121``). JAX anchors the pretrain step's spectrograms, targets and
predictions to P(data, seq) and XLA's partitioner inserts what the sharded
time axis needs between the anchors. Here a data group's S ranks hold the
same rows (the batch is sharded over ``data`` alone), each runs the towers
on its T / S frames, and the modules that read across frames call the
collectives of this module inside a ``sharded(seq)`` block:

- ``halo``: the stride-2 and kernel-5 convolutions (``Conv1dTF``) take the
  few frames their window reaches from each neighbour; the backward sends
  those frames' gradients back to their owners;
- ``gather_time``: the positional conv (K4) and the attention (K2) run on
  the whole T, as XLA runs a Pallas custom call under sharding: gather the
  operand along time, run the kernel, keep this rank's frames; the
  backward reduce-scatters the gradient along time;
- ``local_frames``: a tensor every rank of the group computed whole
  (the featurizer's spectrograms, the teacher's shifted input) cut to this
  rank's frames. Its backward pads with zeros and sums nothing: the
  producers it is used on have no parameters;
- ``positions``: this rank's global frame indices, which the pad masks,
  the valid-frame masks and dropout's draws read;
- ``broadcast_batch`` (the runner's, outside the block): the group's first
  rank's device batch on every rank of the group.

Dropout (``models/spiral/dropout.py``) draws its mask at the global (B, T,
C) and keeps this rank's frames, so a seq group draws the bits of the
unsharded step. Nothing here is called outside a ``sharded`` block, so
every other path is unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from tpu_speech_torch.parallel.mesh import SEQ_AXIS, seq_size


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """A seq group: its process group, its size S and this rank's place."""

    group: Any
    size: int
    index: int


# the seq group of the ``sharded`` block being run (a context variable: a
# thread or task outside the block sees None)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("seq_group", default=None)


def from_mesh(mesh) -> Optional[SeqGroup]:
    """The seq group of a (data, seq) ``DeviceMesh``; None without a seq
    axis."""
    if seq_size(mesh) == 1:
        return None
    return SeqGroup(mesh.get_group(SEQ_AXIS), seq_size(mesh), mesh.get_local_rank(SEQ_AXIS))


@contextlib.contextmanager
def sharded(seq: Optional[SeqGroup]):
    """Within the block the modules run on this rank's frames of ``seq``
    (nothing changes with None)."""
    token = _ACTIVE.set(seq)
    try:
        yield seq
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[SeqGroup]:
    return _ACTIVE.get()


def frame_range(t: int, seq: SeqGroup, multiple: int = 1) -> tuple:
    """[t0, t1) of this rank within a global time axis of ``t`` frames
    (``seq_constrainer``'s P(data, seq) block); each rank's share must be a
    multiple of ``multiple`` (the encoder's total stride)."""
    if t % (seq.size * multiple):
        raise ValueError(f"seq_parallel={seq.size} does not divide {t} frames into "
                         f"shares of a multiple of {multiple} (the encoder's stride)")
    per = t // seq.size
    return seq.index * per, (seq.index + 1) * per


def positions(t_local: int, device, seq: Optional[SeqGroup] = None) -> torch.Tensor:
    """The global frame index of each of this rank's ``t_local`` frames
    (0..t_local - 1 outside a ``sharded`` block)."""
    seq = seq or _ACTIVE.get()
    t0 = 0 if seq is None else seq.index * t_local
    return torch.arange(t0, t0 + t_local, device=device)


def _all_gather_time(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(seq.size)]
    dist.all_gather(parts, x, group=seq.group)
    return torch.cat(parts, dim=1)


def _reduce_scatter_time(g: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The sum over the group of ``g`` (B, T, ...), this rank's frames of
    it; NCCL reduce-scatters, gloo (which has no reduce-scatter) all-reduces
    and slices."""
    per = g.shape[1] // seq.size
    if dist.get_backend(seq.group) == "nccl":
        chunks = [c.contiguous() for c in g.split(per, dim=1)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=seq.group)
        return out
    g = g.contiguous().clone()
    dist.all_reduce(g, group=seq.group)
    return g[:, seq.index * per:(seq.index + 1) * per].contiguous()


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _all_gather_time(x, seq)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_time(g, ctx.seq), None


class _LocalFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, multiple):
        t0, t1 = frame_range(x.shape[1], seq, multiple)
        ctx.full, ctx.t0 = x.shape, t0
        return x[:, t0:t1].contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.full)
        out[:, ctx.t0:ctx.t0 + g.shape[1]] = g
        return out, None, None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, seq):
        b, t = x.shape[:2]
        if left > t or right > t:
            raise ValueError(f"a halo of ({left}, {right}) frames needs at least that many "
                             f"frames a rank, not {t}")
        ctx.left, ctx.right, ctx.seq, ctx.t = left, right, seq, t
        parts = torch.cat([x[:, :right], x[:, t - left:]], dim=1).contiguous()
        edges = [torch.empty_like(parts) for _ in range(seq.size)]
        dist.all_gather(edges, parts, group=seq.group)
        rest = x.shape[2:]
        lo = (edges[seq.index - 1][:, right:] if seq.index > 0
              else x.new_zeros((b, left) + rest))
        hi = (edges[seq.index + 1][:, :right] if seq.index < seq.size - 1
              else x.new_zeros((b, right) + rest))
        return torch.cat([lo, x, hi], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right, seq, t = ctx.left, ctx.right, ctx.seq, ctx.t
        # the gradients of the halo frames go back to the ranks they came from
        parts = torch.cat([g[:, :left], g[:, left + t:]], dim=1).contiguous()
        edges = [torch.empty_like(parts) for _ in range(seq.size)]
        dist.all_gather(edges, parts, group=seq.group)
        dx = g[:, left:left + t].clone()
        if seq.index < seq.size - 1:  # the next rank's left halo is my last frames
            dx[:, t - left:] += edges[seq.index + 1][:, :left]
        if seq.index > 0:  # the previous rank's right halo is my first frames
            dx[:, :right] += edges[seq.index - 1][:, left:]
        return dx, None, None, None


def gather_time(x: torch.Tensor, seq: Optional[SeqGroup] = None) -> torch.Tensor:
    """(B, T / S, ...) on each rank -> the whole (B, T, ...) on every rank;
    the backward sums the gradients over the group and keeps this rank's
    frames (a reduce-scatter)."""
    seq = seq or _ACTIVE.get()
    return _GatherTime.apply(x, seq)


def gather_frames(x: torch.Tensor, seq: Optional[SeqGroup] = None) -> torch.Tensor:
    """``gather_time`` without a gradient (masks, the teacher's targets);
    bool tensors travel as bytes."""
    seq = seq or _ACTIVE.get()
    with torch.no_grad():
        if x.dtype == torch.bool:
            return _all_gather_time(x.to(torch.uint8), seq).bool()
        return _all_gather_time(x, seq)


def local_frames(x: torch.Tensor, seq: Optional[SeqGroup] = None,
                 multiple: int = 1) -> torch.Tensor:
    """This rank's frames of a tensor that every rank of the group holds
    whole (computed alike on each); the backward pads the gradient with
    zeros and sums nothing, so use it only after producers without
    parameters."""
    seq = seq or _ACTIVE.get()
    return _LocalFrames.apply(x, seq, multiple)


def keep_frames(x: torch.Tensor, seq: Optional[SeqGroup] = None) -> torch.Tensor:
    """This rank's frames of a whole-T result computed from gathered
    operands (K2's and K4's outputs): a plain slice, whose backward pads
    with zeros; the gather's backward then sums over the group."""
    seq = seq or _ACTIVE.get()
    per = x.shape[1] // seq.size
    return x[:, seq.index * per:(seq.index + 1) * per]


def broadcast_batch(batch: Optional[dict], seq: SeqGroup, device) -> dict:
    """The batch of the group's first rank on every rank of ``seq`` (the
    others pass None): a data group's ranks must step on the same rows, and
    a loader's crops and noise do not repeat across processes (its threads
    share one generator). The tensors travel as one buffer of bytes (gloo
    has no int16), their shapes and the other values as an object."""
    src = dist.get_global_rank(seq.group, 0)
    box = [None]
    if seq.index == 0:
        box[0] = {k: ("tensor", tuple(v.shape), v.dtype) if torch.is_tensor(v) else ("value", v)
                  for k, v in batch.items()}
    dist.broadcast_object_list(box, src=src, group=seq.group)
    tensors = {k: m[1:] for k, m in box[0].items() if m[0] == "tensor"}
    sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in tensors.values()]
    if seq.index == 0:
        flat = torch.cat([batch[k].contiguous().reshape(-1).view(torch.uint8) for k in tensors])
    else:
        flat = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    dist.broadcast(flat, src=src, group=seq.group)
    if seq.index == 0:
        return dict(batch)
    out = {k: m[1] for k, m in box[0].items() if m[0] == "value"}
    for (k, (shape, dtype)), part in zip(tensors.items(), flat.split(sizes)):
        out[k] = part.clone().view(dtype).reshape(shape)  # a fresh, aligned storage
    return {k: out[k] for k in box[0]}


def halo(x: torch.Tensor, left: int, right: int, seq: Optional[SeqGroup] = None) -> torch.Tensor:
    """(B, t, ...) -> (B, left + t + right, ...): ``left`` frames of the
    previous rank before this rank's frames and ``right`` of the next after
    them, zeros at the ends of the global axis (a convolution's zero pad)."""
    seq = seq or _ACTIVE.get()
    if left == right == 0:
        return x
    return _Halo.apply(x, left, right, seq)
