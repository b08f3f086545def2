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
"""

from __future__ import annotations

import torch

from tpu_speech_torch.ops import _build

__all__ = ["maximum_path", "maximum_path_plain", "MAX_NEG"]

MAX_NEG = -1e9


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


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Most likely monotone alignment path: value (B, Tx, Ty), e.g. the
    Gaussian log-prior, and its validity mask (B, Tx, Ty), the outer product
    of the text and mel masks. Returns the (B, Tx, Ty) 0/1 path in value's
    dtype: the CUDA kernel on a CUDA tensor (which raises where two DP
    columns of Tx floats exceed a block's shared memory),
    ``maximum_path_plain`` on a CPU tensor."""
    if value.ndim != 3 or mask.shape != value.shape:
        raise ValueError(f"value and mask must both be (B, Tx, Ty): "
                         f"{tuple(value.shape)}, {tuple(mask.shape)}")
    if value.device.type == "cpu":
        return maximum_path_plain(value, mask)
    if value.device.type != "cuda" or mask.device != value.device:
        raise ValueError(f"maximum_path: value on {value.device}, mask on {mask.device}")
    b, t_x, t_y = value.shape
    v = value.detach().float().contiguous()
    m = mask.detach().float().contiguous()
    dp = torch.empty((b, t_y, t_x), dtype=torch.float32, device=v.device)
    path = torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(v.device):  # the runtime launches on its current device
        err = lib.tsx_maximum_path(v.data_ptr(), m.data_ptr(), dp.data_ptr(), path.data_ptr(),
                                   b, t_x, t_y, torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(err, "maximum_path")
    _build.LAUNCHES["maximum_path"] += 1
    return path.to(value.dtype)
