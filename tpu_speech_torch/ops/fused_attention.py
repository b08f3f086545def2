"""Merged-qkv self-attention forward: the Hopper kernel and its plain version.

Port of ``tpu_speech/ops/fused_attention.py::fused_qkv_self_attention:416``
(K2, forward only, dropout off). ``fused_qkv_self_attention`` launches the
hand-written CUDA kernel ``csrc/fused_attention.cu`` on a CUDA tensor and
computes ``qkv_attention_plain`` on a CPU tensor; a CUDA tensor it cannot
take raises.

Semantics (both versions): ``qkv`` (B, T, 3E) is the merged projection with
the d_head**-0.5 scale already folded into its q third; head h is the column
slice ``[h*D, (h+1)*D)`` of each third. Padded keys (``key_padding_mask``
True) get the finite score -1e9, so a fully padded row stays finite; the
softmax runs in float32. Returns (B, T, E).

Not ported yet: the backward kernel with in-kernel dropout (K2-bwd), which
the training path needs; ``dropout_p > 0`` raises here.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_speech_torch.ops import _build

__all__ = ["fused_qkv_self_attention", "qkv_attention_plain", "KERNEL_D_HEADS"]

KERNEL_D_HEADS = (8, 16, 32, 64)  # head widths the CUDA kernel is built for


def qkv_attention_plain(
    qkv: torch.Tensor, n_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """einsum scores, -1e9 fill at padded keys, f32 softmax, einsum values."""
    b, t, e3 = qkv.shape
    e = e3 // 3
    q, k, v = qkv.view(b, t, 3, n_heads, e // n_heads).unbind(2)
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, e)


def fused_qkv_self_attention(
    qkv: torch.Tensor, n_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
) -> torch.Tensor:
    """softmax(q k^T, -1e9 at padded keys) v over the merged (B, T, 3E) plane;
    the kernel on CUDA, ``qkv_attention_plain`` on CPU."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout needs the K2 backward/dropout kernel, which is "
            "not ported yet; run the forward with dropout_p=0"
        )
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
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, n_heads, key_padding_mask)
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
    out = torch.empty((b, t, e3 // 3), device=qkv.device, dtype=qkv.dtype)
    lib = _build.library()
    with torch.cuda.device(qkv.device):  # the runtime launches on its current device
        err = lib.tsx_qkv_attention_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), b, t, n_heads, d,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(err, "fused_qkv_self_attention")
    _build.LAUNCHES["fused_qkv_attention"] += 1
    return out
