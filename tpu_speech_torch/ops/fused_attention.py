"""Self-attention with in-kernel dropout: the Hopper kernels, the autograd
functions around them, and their plain versions.

Ports of two entry points of ``tpu_speech/ops/fused_attention.py``:

- ``fused_qkv_self_attention:416``, K2-fwd (``_fused_qkv_attn_fwd:380``) and
  K2-bwd (``_fused_qkv_attn_bwd:396``): ``qkv`` (B, T, 3E) is the merged
  projection, head h the column slice ``[h*D, (h+1)*D)`` of each third;
  returns (B, T, E).
- ``fused_self_attention:452``, K3-fwd (``_fused_attn_fwd:218``) and K3-bwd
  (``_fused_attn_bwd:234``): q, k, v are separate (B, T, H, D) arrays;
  returns (B, T, H, D).

Both launch the same hand-written CUDA kernels on a CUDA tensor (forward,
and backward through ``torch.autograd``): ``csrc/fused_attention.cu`` in
float32, ``csrc/fused_attention_sm90.cu`` (wgmma and TMA) in bfloat16. They
read q, k and v by a row stride (3E for the merged plane, H*D for separate
arrays). On a CPU tensor both compute their plain version; a CUDA tensor they
cannot take raises.

Semantics (every version): q already carries the d_head**-0.5 scale. Padded
keys (``key_padding_mask`` True) get the finite score -1e9, so a fully
padded row stays finite; the softmax runs in float32. With ``dropout_p > 0``
the probabilities are multiplied by ``keep / (1 - p)``, where ``keep`` is the
counter-based mask of ``dropout_keep_mask``: a function of
(seed, (b0 + b)*H + h, i*T + j) that the CUDA kernels compute bit for bit, so
forward, backward and plain version agree under any tiling. ``b0`` (default
0) is the global batch row of the call's first row: a data-parallel rank
passes ``rank * local_B``, so its masks are the rows of the global batch's
that it holds, as the TPU kernel sees the global batch under a mesh (its
``pl.program_id(0)`` is the global row). It is not the TPU's mask: the TPU
draws from its core PRNG, which nothing else reproduces.

The gradient at a padded key is zero (the gradient of the -1e9 fill), as the
JAX package's XLA path gives it; its Pallas backwards differ at a fully
padded row (ROADMAP Queue 3).

dtypes: float32 (the kernels' 3xTF32 path, d_head 8, 12, 16, 32, 64 or 96; 12
runs padded to 16 with zeros) and
bfloat16 (one bf16 wgmma pass, d_head 16, 32, 64 or 96), as the TPU kernels
take the activation's dtype. In bf16 every version rounds where the Pallas
kernels cast (``_qkv_fwd_kernel:282``, ``_qkv_bwd_kernel:312,322``): the
products accumulate in float32 from the bf16 values, the fill and the softmax
run in float32, P~ is rounded to bf16 before P~ v (and before dV), dS is
rounded to bf16 before dQ and dK, and out, dq, dk, dv come back in bf16; the
row logsumexp and the backward's row sums stay float32. The row sums are
Delta = rowsum(dO * out) from the bf16 out, where the Pallas backward sums
dP * P: at T = 1 (dS = 0 but for rounding) that is a few bf16 steps of dq
apart, and at the SPIRAL lengths it is far below one.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_speech_torch.ops import _build

__all__ = [
    "fused_qkv_self_attention", "fused_qkv_attention_fwd", "qkv_attention_plain",
    "fused_self_attention", "attention_plain", "dropout_keep_mask", "dropout_threshold",
    "KERNEL_D_HEADS", "KERNEL_D_HEADS_BF16", "bwd_scratch_floats",
]

KERNEL_D_HEADS = (8, 12, 16, 32, 64, 96)  # head widths the float32 CUDA kernels are built for
KERNEL_D_HEADS_BF16 = (16, 32, 64, 96)  # ... and the bf16 ones (rows of 32-192 bytes)
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
                      device=None, b0: int = 0) -> torch.Tensor:
    """(B, H, T, T) bool keep mask of head h of batch item b at (query i,
    key j), the rows b0 .. b0 + B - 1 of a global batch: bits >= threshold."""
    bh = torch.arange(b0 * h, (b0 + b) * h, dtype=torch.int64, device=device).view(b, h, 1, 1)
    ar = torch.arange(t, dtype=torch.int64, device=device)
    idx = (ar[:, None] * t + ar[None, :]).view(1, 1, t, t)
    return dropout_bits(seed, bh, idx) >= dropout_threshold(dropout_p)


def _bf16_probs(q, k, key_padding_mask, dropout_p, dropout_seed, b0):
    """The float32 softmax P of bf16 q, k and the dropout factor keep / (1 -
    p) (1.0 without dropout)."""
    b, t, h, _ = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask[:, None, None, :], -1e9)
    p = torch.softmax(s, dim=-1)
    if dropout_p <= 0.0:
        return p, 1.0
    keep = dropout_keep_mask(dropout_seed, b, h, t, dropout_p, q.device, b0)
    return p, keep * (1.0 / (1.0 - dropout_p))


class _Bf16Attention(torch.autograd.Function):
    """``attention_plain`` on bf16 q, k, v, rounding where the kernels do:
    P~ to bf16 before P~ v and before dV = P~^T dO; the backward's row sums
    Delta = rowsum(dO * out) in float32 from the bf16 out and dO (the
    kernels' Delta kernel; the Pallas kernel sums dP * P instead, which
    differs by out's rounding); dS = P (dP keep / (1 - p) - Delta), zero at
    padded keys, rounded to bf16 before dQ = dS k and dK = dS^T q."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, dropout_p, dropout_seed, b0):
        p, keep = _bf16_probs(q, k, key_padding_mask, dropout_p, dropout_seed, b0)
        pd = (p * keep).to(v.dtype).float()
        out = torch.einsum("bhts,bshd->bthd", pd, v.float()).to(v.dtype)
        ctx.save_for_backward(q, k, v, key_padding_mask, out)
        ctx.drop = (dropout_p, dropout_seed, b0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out = ctx.saved_tensors
        dtype = v.dtype
        p, keep = _bf16_probs(q, k, mask, *ctx.drop)
        do = dout.to(dtype).float()
        dv = torch.einsum("bhts,bthd->bshd", (p * keep).to(dtype).float(), do)
        dp = torch.einsum("bthd,bshd->bhts", do, v.float()) * keep
        delta = (do * out.float()).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, T, 1)
        ds = p * (dp - delta)
        if mask is not None:
            ds = ds.masked_fill(mask[:, None, None, :], 0.0)
        ds = ds.to(dtype).float()
        dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
        dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
        return dq.to(dtype), dk.to(dtype), dv.to(dtype), None, None, None, None


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None, b0: int = 0,
) -> torch.Tensor:
    """q, k, v (B, T, H, D) -> (B, T, H, D): einsum scores, -1e9 fill at
    padded keys, f32 softmax, the replayed dropout mask of global rows b0
    on, einsum values. Differentiable by autograd. bf16 inputs round where
    the kernels do (``_Bf16Attention``); the products run in float32 on
    their values."""
    if v.dtype == torch.bfloat16:
        return _Bf16Attention.apply(q, k, v, key_padding_mask, dropout_p, dropout_seed, b0)
    b, t, h, _ = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
    p = torch.softmax(scores.float(), dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep_mask(dropout_seed, b, h, t, dropout_p, q.device, b0)
        p = p * keep * (1.0 / (1.0 - dropout_p))
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def qkv_attention_plain(
    qkv: torch.Tensor, n_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None, b0: int = 0,
) -> torch.Tensor:
    """``attention_plain`` on the (B, T, H, D) views of the merged plane's
    thirds; returns (B, T, E)."""
    b, t, e3 = qkv.shape
    e = e3 // 3
    q, k, v = qkv.view(b, t, 3, n_heads, e // n_heads).unbind(2)
    return attention_plain(q, k, v, key_padding_mask, dropout_p,
                           dropout_seed, b0).reshape(b, t, e)


def _suffix(x: torch.Tensor) -> str:
    """The bf16 kernels' entry points and counters carry ``_bf16``."""
    return "_bf16" if x.dtype == torch.bfloat16 else ""


def _fwd(ptrs, ld, mask, b, t, h, d, seed, thresh, scale, with_lse, device, dtype, b0):
    """One forward launch over q, k, v rows at ``ptrs`` with row stride
    ``ld``, the dropout masks of global rows b0 on: returns (out (B, T, H*D)
    in ``dtype``, lse (B, H, T) float32 or None)."""
    out = torch.empty((b, t, h * d), device=device, dtype=dtype)
    lse = (torch.empty((b, h, t), device=device, dtype=torch.float32)
           if with_lse else None)
    lib = _build.library()
    with torch.cuda.device(device):  # the runtime launches on its current device
        err = getattr(lib, "tsx_attention_fwd" + _suffix(out))(
            *ptrs, ld, None if mask is None else mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, t, h, d, seed, b0 * h, thresh, scale,
            torch.cuda.current_stream(device).cuda_stream,
        )
    return err, out, lse


def bwd_scratch_floats(b: int, t: int, h: int, dtype: torch.dtype) -> int:
    """float32 slots of one backward's scratch, TQ = T rounded up to 64. In
    float32: the row sums Delta (B, H, T), then dS^T (B*H, TQ, TQ), which the
    dK/dV kernel writes and the dQ kernel reads. In bf16: L and Delta of each
    (b, h) in rows of TQ, which the dQ kernel writes and the dK/dV kernel
    reads; it recomputes dS and keeps no T x T scratch."""
    tq = -(-t // 64) * 64
    if dtype == torch.float32:
        return (b * h * t + 3) // 4 * 4 + b * h * tq * tq
    return b * h * 2 * tq


def _bwd(ptrs, ld, grad_ptrs, ld_grad, mask, out, dout, lse, h, seed, thresh,
         scale, b0):
    """One backward call writing dq, dk, dv at ``grad_ptrs`` with row stride
    ``ld_grad``: three launches in float32 (Delta, dK/dV, dQ), two in bf16
    (Delta with dQ, then dK/dV). Scratch: ``bwd_scratch_floats``."""
    b, t, e = out.shape
    scratch = torch.empty(bwd_scratch_floats(b, t, h, out.dtype), device=out.device,
                          dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(out.device):
        return getattr(lib, "tsx_attention_bwd" + _suffix(out))(
            *ptrs, ld, None if mask is None else mask.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            *grad_ptrs, ld_grad, b, t, h, e // h, seed, b0 * h, thresh, scale,
            torch.cuda.current_stream(out.device).cuda_stream,
        )


def _thirds(plane: torch.Tensor):
    """Pointers to the q, k and v thirds of a (B, T, 3E) plane."""
    p, step = plane.data_ptr(), plane.shape[2] // 3 * plane.element_size()
    return p, p + step, p + 2 * step


def _launch_fwd(qkv, mask, n_heads, seed, thresh, scale, with_lse, b0=0):
    """K2-fwd on the merged plane: (out (B, T, E), lse or None)."""
    b, t, e3 = qkv.shape
    err, out, lse = _fwd(_thirds(qkv), e3, mask, b, t, n_heads, e3 // 3 // n_heads,
                         seed, thresh, scale, with_lse, qkv.device, qkv.dtype, b0)
    _build.check(err, "fused_qkv_self_attention")
    _build.LAUNCHES["fused_qkv_attention" + _suffix(qkv)] += 1
    return out, lse


def _launch_bwd(qkv, mask, out, dout, lse, n_heads, seed, thresh, scale, b0=0):
    """K2-bwd: dqkv (B, T, 3E), written into the plane's thirds."""
    dqkv = torch.empty_like(qkv)
    err = _bwd(_thirds(qkv), qkv.shape[2], _thirds(dqkv), qkv.shape[2], mask,
               out, dout, lse, n_heads, seed, thresh, scale, b0)
    _build.check(err, "fused_qkv_self_attention backward")
    _build.LAUNCHES["fused_qkv_attention_bwd" + _suffix(qkv)] += 1
    return dqkv


def _launch_attn_fwd(q, k, v, mask, seed, thresh, scale, with_lse, b0=0):
    """K3-fwd on contiguous (B, T, H, D) q, k, v: (out (B, T, H, D), lse)."""
    b, t, h, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    err, out, lse = _fwd(ptrs, h * d, mask, b, t, h, d, seed, thresh, scale,
                         with_lse, q.device, q.dtype, b0)
    _build.check(err, "fused_self_attention")
    _build.LAUNCHES["fused_attention" + _suffix(q)] += 1
    return out.view(b, t, h, d), lse


def _launch_attn_bwd(q, k, v, mask, out, dout, lse, seed, thresh, scale, b0=0):
    """K3-bwd: (dq, dk, dv), each (B, T, H, D)."""
    b, t, h, d = q.shape
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    err = _bwd((q.data_ptr(), k.data_ptr(), v.data_ptr()), h * d,
               tuple(g.data_ptr() for g in grads), h * d, mask,
               out.view(b, t, h * d), dout.view(b, t, h * d), lse, h, seed,
               thresh, scale, b0)
    _build.check(err, "fused_self_attention backward")
    _build.LAUNCHES["fused_attention_bwd" + _suffix(q)] += 1
    return grads


class _FusedQKVAttention(torch.autograd.Function):
    """K2-fwd saving the row logsumexp, and K2-bwd as its backward."""

    @staticmethod
    def forward(ctx, qkv, mask, n_heads, seed, thresh, scale, b0):
        out, lse = _launch_fwd(qkv, mask, n_heads, seed, thresh, scale, True, b0)
        ctx.save_for_backward(qkv, out, lse)
        ctx.mask, ctx.args = mask, (n_heads, seed, thresh, scale, b0)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = _launch_bwd(qkv, ctx.mask, out, dout.contiguous(), lse, *ctx.args)
        return dqkv, None, None, None, None, None, None


class _FusedAttention(torch.autograd.Function):
    """K3-fwd saving the row logsumexp, and K3-bwd as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, thresh, scale, b0):
        out, lse = _launch_attn_fwd(q, k, v, mask, seed, thresh, scale, True, b0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask, ctx.args = mask, (seed, thresh, scale, b0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_attn_bwd(q, k, v, ctx.mask, out, dout.contiguous(),
                                      lse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _check_common(x, b, t, key_padding_mask, dropout_p, dropout_seed, name):
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _kernel_args(x, d, key_padding_mask, dropout_p, dropout_seed, name):
    """Checks of what the CUDA kernels take; (mask, seed, threshold, scale)."""
    heads = {torch.float32: KERNEL_D_HEADS, torch.bfloat16: KERNEL_D_HEADS_BF16}
    if d not in heads.get(x.dtype, ()):
        raise ValueError(
            f"{name} kernel takes float32 with d_head in {KERNEL_D_HEADS} or bfloat16 "
            f"with d_head in {KERNEL_D_HEADS_BF16}: got {x.dtype}, d_head={d}"
        )
    if key_padding_mask is not None and key_padding_mask.device != x.device:
        raise ValueError("key_padding_mask must be on the device of q, k, v")
    mask = None if key_padding_mask is None else key_padding_mask.contiguous()
    seed = dropout_seed if dropout_p > 0.0 else 0
    thresh = dropout_threshold(dropout_p) if dropout_p > 0.0 else 0
    return mask, seed, thresh, 1.0 / (1.0 - dropout_p)


@torch.library.custom_op("tpu_speech::fused_qkv_attention_fwd", mutates_args=())
def fused_qkv_attention_fwd(qkv: torch.Tensor, n_heads: int,
                            key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2-fwd without dropout as a registered op, which ``torch.export``
    keeps in its graph: the kernel on a CUDA tensor (float32 or bf16),
    ``qkv_attention_plain`` on a CPU one. No backward: training keeps
    ``_FusedQKVAttention``."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, n_heads, key_padding_mask)
    mask, seed, thresh, scale = _kernel_args(qkv, qkv.shape[2] // 3 // n_heads,
                                             key_padding_mask, 0.0, None,
                                             "fused_qkv_self_attention")
    return _launch_fwd(qkv.contiguous(), mask, n_heads, seed, thresh, scale, False)[0]


@fused_qkv_attention_fwd.register_fake
def _(qkv, n_heads, key_padding_mask=None):
    b, t, e3 = qkv.shape
    return qkv.new_empty((b, t, e3 // 3))


def fused_qkv_self_attention(
    qkv: torch.Tensor, n_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None, b0: int = 0,
) -> torch.Tensor:
    """softmax(q k^T, -1e9 at padded keys) [dropout] v over the merged
    (B, T, 3E) plane; the kernels on CUDA, ``qkv_attention_plain`` on CPU.
    A forward without dropout or autograd goes through the registered op
    ``tpu_speech::fused_qkv_attention_fwd``.

    ``dropout_seed``: a non-negative int (< 2**31) per (layer, step);
    required when ``dropout_p > 0``. ``b0``: the global batch row of
    ``qkv``'s first row, which keys the dropout masks.
    """
    if qkv.ndim != 3 or qkv.shape[2] % (3 * n_heads):
        raise ValueError(f"qkv must be (B, T, 3E) with E % n_heads == 0: {tuple(qkv.shape)}")
    b, t, e3 = qkv.shape
    _check_common(qkv, b, t, key_padding_mask, dropout_p, dropout_seed,
                  "fused_qkv_self_attention")
    grad = torch.is_grad_enabled() and qkv.requires_grad
    if dropout_p == 0.0 and not grad:
        return fused_qkv_attention_fwd(qkv, n_heads, key_padding_mask)
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, n_heads, key_padding_mask, dropout_p,
                                   dropout_seed, b0)
    mask, seed, thresh, scale = _kernel_args(qkv, e3 // 3 // n_heads, key_padding_mask,
                                             dropout_p, dropout_seed,
                                             "fused_qkv_self_attention")
    qkv = qkv.contiguous()
    if grad:
        return _FusedQKVAttention.apply(qkv, mask, n_heads, seed, thresh, scale, b0)
    return _launch_fwd(qkv, mask, n_heads, seed, thresh, scale, False, b0)[0]


def fused_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0, dropout_seed: Optional[int] = None, b0: int = 0,
) -> torch.Tensor:
    """softmax(q k^T, -1e9 at padded keys) [dropout] v with q, k, v
    (B, T, H, D) and q pre-scaled; returns (B, T, H, D). The K3 kernels on
    CUDA (dq, dk, dv through autograd), ``attention_plain`` on CPU.

    ``dropout_seed``: a non-negative int (< 2**31); required when
    ``dropout_p > 0``. ``b0`` as for ``fused_qkv_self_attention``.
    """
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be equal (B, T, H, D): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    _check_common(q, b, t, key_padding_mask, dropout_p, dropout_seed,
                  "fused_self_attention")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_padding_mask, dropout_p, dropout_seed, b0)
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must share a dtype and a device")
    mask, seed, thresh, scale = _kernel_args(q, d, key_padding_mask, dropout_p,
                                             dropout_seed, "fused_self_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedAttention.apply(q, k, v, mask, seed, thresh, scale, b0)
    return _launch_attn_fwd(q, k, v, mask, seed, thresh, scale, False, b0)[0]
