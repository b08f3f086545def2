"""Monotonic alignment search (MAS): the hand-written CUDA kernel and its
plain version.

The port's counterpart of ``tpu_speech/ops/monotonic_align.py::maximum_path:27``,
which the JAX package compiles as one ``lax.scan`` over the Ty mel columns and
a reversed scan for the backtrace. ``maximum_path`` launches the kernel of
``csrc/monotonic_align.cu`` on a CUDA tensor and computes
``maximum_path_plain`` on a CPU tensor. ``maximum_path_plain`` is the scan
written as a loop over columns, line for line: ``value * mask`` in fp32,
``MAX_NEG = -1e9``, "stay" gated only at x == y, the virtual start cell at
y == 0; in the backtrace a step down only when ``v_i < v_im1`` (ties stay),
with the index re-pinned to ``t_x - 1`` until the row's last column. Both
versions do each cell's add of a max in fp32, so their paths are equal bit
for bit. (This is the JAX formulation, not ``maximum_path_numpy``'s narrowed
x range: which cells hold -1e9 sums decides the values the backtrace
compares.)

The kernel keeps the DP in one warp's registers (Tx <= 1024; a block of
1024 threads above that) and records each cell's backtrace decision as a
bit; ``kernel_plan`` reports its launch for a (Tx, Ty), including whether
those bits need a uint32 scratch in device memory (where they do not fit in
shared memory), which the wrapper then allocates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_speech_torch.ops import _build

__all__ = ["maximum_path", "maximum_path_plain", "kernel_plan", "MAX_NEG"]

MAX_NEG = -1e9
_PLAN_KEYS = ("block_path", "width", "cols", "stages", "bits_in_smem", "smem_bytes",
              "words_per_column", "chunk", "scratch_words")


def _lengths(mask: torch.Tensor):
    """(t_xs, t_ys): the mask's row and column counts, as the scan takes them
    (float sums cast to int)."""
    return mask[:, :, 0].sum(1).long(), mask[:, 0, :].sum(1).long()


def maximum_path_plain(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, Tx, Ty) value and mask -> the (B, Tx, Ty) 0/1 path in value's
    dtype; a Python loop of Ty columns, then Ty backtrace steps."""
    dtype = value.dtype
    b, t_x, t_y = value.shape
    value = (value * mask).float()
    mask = mask.float()
    t_xs, t_ys = _lengths(mask)
    x_idx = torch.arange(t_x, device=value.device)

    # forward DP, one column at a time
    prev = torch.full((b, t_x), MAX_NEG, device=value.device)
    cols = []
    for y in range(t_y):
        stay = torch.where(x_idx[None, :] == y, MAX_NEG, prev)
        start = torch.full((b, 1), 0.0 if y == 0 else MAX_NEG, device=value.device)
        adv = torch.cat([start, prev[:, :-1]], dim=1)
        prev = value[:, :, y] + torch.maximum(stay, adv)
        cols.append(prev)

    # backtrace, from the last column down
    index = t_xs - 1
    rows = [None] * t_y
    for y in reversed(range(t_y)):
        active = y < t_ys
        index = torch.where(y >= t_ys - 1, t_xs - 1, index)
        rows[y] = ((x_idx[None, :] == index[:, None]) & active[:, None]).float()
        if y > 0:
            vprev = cols[y - 1]
            at = index.clamp(0, t_x - 1)[:, None]
            v_i = torch.gather(vprev, 1, at)[:, 0]
            v_im1 = torch.gather(vprev, 1, (at - 1).clamp(min=0))[:, 0]
            down = (index != 0) & ((index == y) | (v_i < v_im1)) & active
            index = index - down.long()
    return torch.stack(rows, dim=2).to(dtype)


@functools.lru_cache(maxsize=256)
def kernel_plan(t_x: int, t_y: int) -> dict:
    """The kernel's launch for a (Tx, Ty) grid, from the library
    (``tsx_maximum_path_plan``): ``block_path`` (0: one DP warp, 1: a block
    of 1024 threads), ``width`` (cells a lane, or a thread), the ring's
    ``cols`` and ``stages``, ``bits_in_smem``, ``smem_bytes``,
    ``words_per_column``, the backtrace's ``chunk`` of columns and
    ``scratch_words`` (the decision words a batch row needs in device memory,
    0 when they stay in shared memory). Raises ValueError for a shape the
    kernel does not take (Tx above 29 055)."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _build.library().tsx_maximum_path_plan(t_x, t_y, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"maximum_path kernel: no launch for Tx={t_x}, Ty={t_y}")
    return dict(zip(_PLAN_KEYS, out))


def maximum_path(value: torch.Tensor, mask: torch.Tensor,
                 stamps: torch.Tensor | None = None) -> torch.Tensor:
    """Most likely monotone alignment path: value (B, Tx, Ty), e.g. the
    Gaussian log-prior, and its validity mask (B, Tx, Ty), the outer product
    of the text and mel masks. Returns the (B, Tx, Ty) 0/1 path in value's
    dtype: the CUDA kernel on a CUDA tensor, ``maximum_path_plain`` on a CPU
    tensor. ``stamps``, an int64 (B, 10) CUDA tensor, receives the kernel's
    clock stamps of each batch row (see ``csrc/monotonic_align.cu``)."""
    if value.ndim != 3 or mask.shape != value.shape:
        raise ValueError(f"value and mask must both be (B, Tx, Ty): "
                         f"{tuple(value.shape)}, {tuple(mask.shape)}")
    if value.device.type == "cpu":
        return maximum_path_plain(value, mask)
    if value.device.type != "cuda" or mask.device != value.device:
        raise ValueError(f"maximum_path: value on {value.device}, mask on {mask.device}")
    b, t_x, t_y = value.shape
    if stamps is not None and (stamps.shape != (b, 10) or stamps.dtype != torch.int64
                               or stamps.device != value.device):
        raise ValueError(f"maximum_path: stamps must be int64 (B, 10) on {value.device}")
    v = value.detach().float().contiguous()
    m = mask.detach().float().contiguous()
    path = torch.empty_like(v)
    bits = None
    if v.numel():
        words = kernel_plan(t_x, t_y)["scratch_words"]
        if words:
            bits = torch.empty(b * words, dtype=torch.int32, device=v.device)
    lib = _build.library()
    with torch.cuda.device(v.device):  # the runtime launches on its current device
        err = lib.tsx_maximum_path(v.data_ptr(), m.data_ptr(),
                                   None if bits is None else bits.data_ptr(), path.data_ptr(),
                                   b, t_x, t_y, None if stamps is None else stamps.data_ptr(),
                                   torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(err, "maximum_path")
    _build.LAUNCHES["maximum_path"] += 1
    return path.to(value.dtype)
