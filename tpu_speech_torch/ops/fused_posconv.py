"""Grouped 1-D convolution (the transformer's positional conv): the Hopper
kernel, the autograd function around it, and its plain version.

Port of ``tpu_speech/ops/fused_posconv.py::grouped_conv1d:190`` (K4,
``_pallas_fwd:121``; its VJP ``_bwd:198``). ``grouped_conv1d`` launches a
hand-written CUDA kernel on a CUDA tensor (``csrc/fused_posconv.cu`` for
float32, ``csrc/fused_posconv_sm90.cu`` for bf16) and computes
``grouped_conv1d_plain`` on a CPU tensor; a CUDA tensor or shape it cannot
take raises. On CUDA the bf16 weights are laid out for the kernel by a second
kernel of ``csrc/fused_posconv_sm90.cu`` (``kernel_weights``, ``_dx_weights``),
whose plain version is ``weights_plain``.

Semantics (both versions), channels last as in JAX: x (B, T, C), w (C, Cg, K)
in PyTorch's grouped conv layout (``F.conv1d``'s weight, Cg = C / groups),
output (B, T, C) with::

    out[b, t, o] = sum_k sum_ci xp[b, t + k, g*Cg + ci] * w[o, ci, k],
    xp = pad(x, (left_pad, K - 1 - left_pad)) in time,  g = o // Cg.

``left_pad = K // 2`` is the SAME-even pad with the trailing frame trimmed
(the positional conv); ``K - 1`` is causal.

Gradients on CUDA, as the JAX VJP computes them: dx by the same kernel on
the k-flipped, in/out-swapped weights with the complementary left pad
``K - 1 - left_pad``; dw by the library's convolution weight gradient (JAX
leaves dw to XLA's native conv, outside any Pallas kernel).

dtypes: float32 (the kernel's 3xTF32 path, any C/groups <= 64) and bfloat16
(one bf16 wgmma pass, C/groups in 16, 32, 48, 64), as the TPU kernel
takes the activation's dtype (``_fwd_kernel:72-115``, dx in x's dtype,
``_bwd:222-223``). In bf16 both versions sum the products of the bf16 values
in float32 and round the output to bf16 once; dw is the library's bf16
weight gradient, as XLA's bf16 conv gives it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_speech_torch.ops import _build

__all__ = ["grouped_conv1d", "grouped_conv1d_plain", "kernel_weights", "weights_plain",
           "KERNEL_MAX_CG", "KERNEL_MAX_K", "KERNEL_CG_BF16"]

KERNEL_MAX_CG = 64  # channels per group the float32 CUDA kernel takes
KERNEL_MAX_K = 128  # taps the CUDA kernels take
KERNEL_CG_BF16 = (16, 32, 48, 64)  # channels per group the bf16 kernel takes


def grouped_conv1d_plain(x: torch.Tensor, w: torch.Tensor, groups: int,
                         left_pad: int) -> torch.Tensor:
    """``F.conv1d(groups=...)`` on the explicitly padded (B, C, T) input;
    bf16 in float32 on the bf16 values, rounded to bf16 once. Differentiable
    by autograd."""
    k = w.shape[-1]
    low = x.dtype == torch.bfloat16
    xp = F.pad((x.float() if low else x).transpose(1, 2), (left_pad, k - 1 - left_pad))
    y = F.conv1d(xp, w.float() if low else w, groups=groups).transpose(1, 2)
    return y.to(x.dtype) if low else y


def kernel_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(C, Cg, K) -> the kernel's weights: (G, K, Cg_in, Cg_out) for
    float32; for bf16 (G, K, Cg_in/8, Cg_out, 8), [g, k, ci // 8, co, ci %
    8], tap k's slab in wgmma's K-major layout of 8-channel core matrices.
    bf16 on CUDA: one launch of the layout kernel; else one copy
    (``weights_plain``)."""
    if w.dtype == torch.bfloat16 and w.device.type == "cuda":
        return _layout_bf16(w, groups, dx=False)
    return weights_plain(w, groups, dx=False)


def _dx_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The kernel weights of dx: tap K-1-k of w with input and output
    channels swapped: (G, K, Cg_out, Cg_in) for float32, (G, K, Cg_out/8,
    Cg_in, 8) for bf16 (w's output channels are dx's inputs). bf16 on CUDA:
    one launch of the layout kernel; else ``weights_plain``."""
    if w.dtype == torch.bfloat16 and w.device.type == "cuda":
        return _layout_bf16(w, groups, dx=True)
    return weights_plain(w, groups, dx=True)


def weights_plain(w: torch.Tensor, groups: int, dx: bool = False) -> torch.Tensor:
    """``kernel_weights`` (or with ``dx`` ``_dx_weights``) by PyTorch's
    permute and copy: the plain version of the bf16 layout kernel, and the
    float32 kernel's layout on any device."""
    c, cg, k = w.shape
    w4 = w.reshape(groups, cg, cg, k)  # (G, out, in, K)
    if dx:
        w4 = w4.flip(3)
        if w.dtype == torch.bfloat16:  # (G, out/8, 8, in, K)
            return w4.reshape(groups, cg // 8, 8, cg, k).permute(0, 4, 1, 3, 2).contiguous()
        return w4.permute(0, 3, 1, 2).contiguous()
    if w.dtype == torch.bfloat16:  # (G, out, in/8, 8, K)
        return w4.reshape(groups, cg, cg // 8, 8, k).permute(0, 4, 2, 1, 3).contiguous()
    return w4.permute(0, 3, 2, 1).contiguous()


def _layout_bf16(w, groups, dx):
    """The bf16 layout kernel (``csrc/fused_posconv_sm90.cu``) on w's stream."""
    c, cg, k = w.shape
    w = w.contiguous()
    out = torch.empty(groups, k, cg // 8, cg, 8, dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        err = _build.library().tsx_grouped_conv1d_bf16_weights(
            w.data_ptr(), out.data_ptr(), groups, cg, k, int(dx),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    _build.check(err, "grouped_conv1d_bf16_weights")
    return out


def _launch(x, wk, left_pad, counter):
    b, t, c = x.shape
    g, k = wk.shape[0], wk.shape[1]
    out = torch.empty_like(x)
    suffix = "_bf16" if x.dtype == torch.bfloat16 else ""
    lib = _build.library()
    with torch.cuda.device(x.device):  # the runtime launches on its current device
        err = getattr(lib, "tsx_grouped_conv1d" + suffix)(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), b, t, c, g, k, left_pad,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, counter + suffix)
    _build.LAUNCHES[counter + suffix] += 1
    return out


class _GroupedConv1d(torch.autograd.Function):
    """K4 forward; K4 again for dx, the library's weight gradient for dw."""

    @staticmethod
    def forward(ctx, x, w, groups, left_pad):
        ctx.save_for_backward(x, w)
        ctx.groups, ctx.left_pad = groups, left_pad
        return _launch(x, kernel_weights(w, groups), left_pad, "grouped_conv1d")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        groups, left_pad = ctx.groups, ctx.left_pad
        k = w.shape[-1]
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _launch(dy, _dx_weights(w, groups), k - 1 - left_pad,
                         "grouped_conv1d_dx")
        if ctx.needs_input_grad[1]:
            xp = F.pad(x.transpose(1, 2), (left_pad, k - 1 - left_pad))
            dw = torch.nn.grad.conv1d_weight(xp, w.shape, dy.transpose(1, 2),
                                             groups=groups)
        return dx, dw, None, None


def grouped_conv1d(x: torch.Tensor, w: torch.Tensor, groups: int,
                   left_pad: int) -> torch.Tensor:
    """Grouped conv of x (B, T, C) with w (C, C/groups, K) and ``left_pad``
    zeros before the first frame; the K4 kernel on CUDA (float32 with any
    C/groups <= 64, bf16 with C/groups in 16, 32, 48, 64; K <= 128),
    ``grouped_conv1d_plain`` on CPU."""
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"x must be (B, T, C) and w (C, Cg, K): "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    c, k = x.shape[2], w.shape[2]
    if groups < 1 or c % groups or w.shape[:2] != (c, c // groups):
        raise ValueError(f"w must be (C, C/groups, K) = ({c}, {c}/{groups}, K): "
                         f"{tuple(w.shape)}")
    if not 0 <= left_pad < k:
        raise ValueError(f"left_pad must be in [0, K = {k}): {left_pad}")
    if x.device.type == "cpu":
        return grouped_conv1d_plain(x, w, groups, left_pad)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_conv1d: unsupported device {x.device}")
    cg = c // groups
    cg_ok = {torch.float32: cg <= KERNEL_MAX_CG,
             torch.bfloat16: cg in KERNEL_CG_BF16}.get(x.dtype, False)
    if w.dtype != x.dtype or w.device != x.device or not cg_ok or k > KERNEL_MAX_K:
        raise ValueError(
            f"grouped_conv1d kernel takes x and w of one dtype on one device, "
            f"float32 with C/groups <= {KERNEL_MAX_CG} or bfloat16 with C/groups in "
            f"{KERNEL_CG_BF16}, and K <= {KERNEL_MAX_K}: got {x.dtype}/{w.dtype} on "
            f"{x.device}/{w.device}, C/groups={cg}, K={k}"
        )
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedConv1d.apply(x, w, groups, left_pad)
    return _launch(x, kernel_weights(w, groups), left_pad, "grouped_conv1d")
