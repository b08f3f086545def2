"""The device an entry point runs on, and the port's fp32 switches."""

from __future__ import annotations

import torch


def use_full_fp32() -> None:
    """fp32 serving: PyTorch runs cuDNN convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32 = True``), which keeps ~3 decimal
    digits; the reference path is full fp32, so TF32 goes off for
    convolutions and matmuls alike. bf16 matmuls (the training steps' mixed
    precision) accumulate in fp32 throughout, as the TPU's bf16 products do:
    cuBLAS's reduced-precision reductions go off too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device="cuda") -> torch.device:
    """An entry point's device: CUDA unless another is named; no silent fall
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if device.type == "cuda":
        use_full_fp32()
    return device
