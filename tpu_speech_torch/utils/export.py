"""Model export: serialized ``torch.export`` programs (``.pt2`` files).

The port's counterpart of ``tpu_speech/utils/export.py`` (``export_fn:18``,
``load_exported:28``): an inference function is traced once at example
arguments and serialized with its weights, so a program can run it without
the Python model definitions. Where the JAX package lowers to StableHLO for
a list of platforms, an ``ExportedProgram`` is traced for one device: the
example arguments' (the CLIs take ``--device`` where JAX's take
``--platforms``).

The hand kernels of the SPIRAL path stay in the graph as the ``tpu_speech::``
ops that ``tpu_speech_torch.ops`` registers (``fused_logmel``,
``fused_qkv_attention_fwd``, ``grouped_posconv``), so a program that loads
such an artifact imports ``tpu_speech_torch.ops`` first.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from tpu_speech_torch.utils.device import use_full_fp32


class _Function(torch.nn.Module):
    """A plain callable as a module, so that ``torch.export`` traces it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, example_args: Sequence[Any], path: str,
              dynamic_shapes=None) -> None:
    """Trace ``fn`` (a module, or a callable) at ``example_args`` without
    autograd, and save the program to ``path`` (a ``.pt2``). A module's
    parameters and buffers are saved with it; tensors a plain callable
    closes over are saved as constants. ``dynamic_shapes``: as
    ``torch.export.export`` takes it (default: every shape static, as
    JAX's export at concrete arguments)."""
    module = fn if isinstance(fn, torch.nn.Module) else _Function(fn)
    with torch.no_grad():
        exported = torch.export.export(module, tuple(example_args),
                                       dynamic_shapes=dynamic_shapes)
    torch.export.save(exported, path)


class Exported:
    """A loaded program; ``call(*args)`` runs it, as the JAX artifact's does."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, *args):
        with torch.no_grad():
            return self._module(*args)


def _on_cuda(program) -> bool:
    """Whether a program's weights or constants lie on a CUDA device."""
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


def load_exported(path: str) -> Exported:
    """Load a ``.pt2`` written by ``export_fn``; returns an object with
    ``.call``. A graph that holds the ``tpu_speech::`` kernel ops needs
    ``import tpu_speech_torch.ops`` before this call (this module does it).
    A program on the card runs in full fp32: this call turns TF32 off
    (``utils/device.py::use_full_fp32``), as every entry point of the port
    does. That is a setting of the process, which the graph does not carry."""
    import tpu_speech_torch.ops  # noqa: F401  (registers the tpu_speech:: ops)

    program = torch.export.load(path)
    if _on_cuda(program):
        use_full_fp32()
    return Exported(program)
