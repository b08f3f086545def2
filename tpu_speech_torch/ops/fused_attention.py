"""Merged-qkv self-attention with in-kernel dropout: the Hopper kernels, the
autograd function around them, and their plain version.

Port of ``tpu_speech/ops/fused_attention.py::fused_qkv_self_attention:416``:
K2-fwd (``_fused_qkv_attn_fwd:380``) and K2-bwd (``_fused_qkv_attn_bwd:396``).
``fused_qkv_self_attention`` launches the hand-written CUDA kernels of
``csrc/fused_attention.cu`` on a CUDA tensor (forward, and backward through
``torch.autograd``) and computes ``qkv_attention_plain`` on a CPU tensor; a
CUDA tensor it cannot take raises.

Semantics (both versions): ``qkv`` (B, T, 3E) is the merged projection with
the d_head**-0.5 scale already folded into its q third; head h is the column
slice ``[h*D, (h+1)*D)`` of each third. Padded keys (``key_padding_mask``
True) get the finite score -1e9, so a fully padded row stays finite; the
softmax runs in float32. With ``dropout_p > 0`` the probabilities are
multiplied by ``keep / (1 - p)``, where ``keep`` is the counter-based mask of
``dropout_keep_mask``: a function of (seed, b*H + h, i*T + j) that the CUDA
kernels compute bit for bit, so forward, backward and plain version agree
under any tiling. It is not the TPU's mask: the TPU draws from its core
PRNG, which nothing else reproduces. Returns (B, T, E).

The gradient at a padded key is zero (the gradient of the -1e9 fill), as the
JAX package's XLA path gives it.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_speech_torch.ops import _build

__all__ = [
    "fused_qkv_self_attention", "qkv_attention_plain", "dropout_keep_mask",
    "dropout_threshold", "KERNEL_D_HEADS",
]

KERNEL_D_HEADS = (8, 16, 32, 64)  # head widths the CUDA kernels are built for
_M32 = 0xFFFFFFFF


def dropout_threshold(dropout_p: float) -> int:
    """keep = bits >= threshold (the TPU kernel's ``_keep_mask:88``)."""
    return min(int(dropout_p * 2.0**32), _M32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 in int64 without overflow: a < 2**32, c split in
    16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed: int, bh: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernels' ``dropout_bits(dropout_stream(seed, bh), idx)`` as int64
    in [0, 2**32): bh = b*H + h, idx = i*T + j (broadcast together)."""
    stream = _fmix32(_fmix32((bh + 0x9E3779B9) & _M32) ^ (seed & _M32))
    return _fmix32(stream ^ _mul32(idx, 0x9E3779B1))


def dropout_keep_mask(seed: int, b: int, h: int, t: int, dropout_p: float,
                      device=None) -> torch.Tensor:
    """(B, H, T, T) bool keep mask of head h of batch item b at (query i,
    key j): bits >= threshold."""
    bh = torch.arange(b * h, dtype=torch.int64, device=device).view(b, h, 1, 1)
    ar = torch.arange(t, dtype=torch.int64, device=device)
    idx = (ar[:, None] * t + ar[None, :]).view(1, 1, t, t)
    return dropout_bits(seed, bh, idx) >= dropout_threshold(dropout_p)


def qkv_attention_plain(
    qkv: torch.Tensor, n_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """einsum scores, -1e9 fill at padded keys, f32 softmax, the replayed
    dropout mask, einsum values. Differentiable by autograd."""
    b, t, e3 = qkv.shape
    e = e3 // 3
    q, k, v = qkv.view(b, t, 3, n_heads, e // n_heads).unbind(2)
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
    p = torch.softmax(scores.float(), dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep_mask(dropout_seed, b, n_heads, t, dropout_p, qkv.device)
        p = p * keep * (1.0 / (1.0 - dropout_p))
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v).reshape(b, t, e)


def _launch_fwd(qkv, mask, n_heads, seed, thresh, scale, with_lse):
    b, t, e3 = qkv.shape
    out = torch.empty((b, t, e3 // 3), device=qkv.device, dtype=qkv.dtype)
    lse = (torch.empty((b, n_heads, t), device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    lib = _build.library()
    with torch.cuda.device(qkv.device):  # the runtime launches on its current device
        err = lib.tsx_qkv_attention_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, t, n_heads, e3 // 3 // n_heads, seed, thresh, scale,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(err, "fused_qkv_self_attention")
    _build.LAUNCHES["fused_qkv_attention"] += 1
    return out, lse


def _launch_bwd(qkv, mask, out, dout, lse, n_heads, seed, thresh, scale):
    b, t, e3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, n_heads, t), device=qkv.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = lib.tsx_qkv_attention_bwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), b, t, n_heads, e3 // 3 // n_heads, seed, thresh,
            scale, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(err, "fused_qkv_self_attention backward")
    _build.LAUNCHES["fused_qkv_attention_bwd"] += 1
    return dqkv


class _FusedQKVAttention(torch.autograd.Function):
    """K2-fwd saving the row logsumexp, and K2-bwd as its backward."""

    @staticmethod
    def forward(ctx, qkv, mask, n_heads, seed, thresh, scale):
        out, lse = _launch_fwd(qkv, mask, n_heads, seed, thresh, scale, True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.mask, ctx.args = mask, (n_heads, seed, thresh, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = _launch_bwd(qkv, ctx.mask, out, dout.contiguous(), lse, *ctx.args)
        return dqkv, None, None, None, None, None


def fused_qkv_self_attention(
    qkv: torch.Tensor, n_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """softmax(q k^T, -1e9 at padded keys) [dropout] v over the merged
    (B, T, 3E) plane; the kernels on CUDA, ``qkv_attention_plain`` on CPU.

    ``dropout_seed``: a non-negative int (< 2**31) per (layer, step);
    required when ``dropout_p > 0``.
    """
    if qkv.ndim != 3 or qkv.shape[2] % (3 * n_heads):
        raise ValueError(f"qkv must be (B, T, 3E) with E % n_heads == 0: {tuple(qkv.shape)}")
    b, t, e3 = qkv.shape
    if key_padding_mask is not None and (
        key_padding_mask.shape != (b, t) or key_padding_mask.dtype != torch.bool
    ):
        raise ValueError(
            f"key_padding_mask must be bool (B, T) = {(b, t)}: "
            f"{key_padding_mask.dtype} {tuple(key_padding_mask.shape)}"
        )
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1): {dropout_p}")
    if dropout_p > 0.0 and (dropout_seed is None or not 0 <= dropout_seed < 2**31):
        raise ValueError(f"dropout_p > 0 needs a dropout_seed in [0, 2**31): {dropout_seed}")
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, n_heads, key_padding_mask, dropout_p,
                                   dropout_seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_self_attention: unsupported device {qkv.device}")
    d = e3 // 3 // n_heads
    if qkv.dtype != torch.float32 or d not in KERNEL_D_HEADS:
        raise ValueError(
            f"fused_qkv_self_attention kernel takes float32 with d_head in "
            f"{KERNEL_D_HEADS}: got {qkv.dtype}, d_head={d}"
        )
    if key_padding_mask is not None and key_padding_mask.device != qkv.device:
        raise ValueError("key_padding_mask must be on the qkv device")
    qkv = qkv.contiguous()
    mask = None if key_padding_mask is None else key_padding_mask.contiguous()
    seed = dropout_seed if dropout_p > 0.0 else 0
    thresh = dropout_threshold(dropout_p) if dropout_p > 0.0 else 0
    scale = 1.0 / (1.0 - dropout_p)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedQKVAttention.apply(qkv, mask, n_heads, seed, thresh, scale)
    return _launch_fwd(qkv, mask, n_heads, seed, thresh, scale, False)[0]
