"""Checkpoint save/restore with latest-resume semantics, as torch files.

The port's counterpart of ``tpu_speech/utils/checkpoint.py`` (orbax there,
which imports JAX): one file a step, ``<dir>/step_{step:010d}.pt``, holding
whatever dict of tensors and numbers the caller passes (a trainer's model
``state_dict``, its optimizer's moments and count, the step). Each save is
written to a temporary name and renamed, so a file under the final name is
always whole. ``save`` copies the state to host memory and writes it on a
background thread; the next save, restore or ``wait`` drains it first, so at
most one write is in flight.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from typing import Any, Optional

import torch


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` (nested dicts) with every tensor detached on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


class Checkpointer:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step:010d}.pt")

    def _write(self, step: int, state: Any) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.ckpt_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(state, f)
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def _write_in_background(self, step: int, state: Any) -> None:
        try:
            self._write(step, state)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as step ``step``: returns once the state is copied
        to host memory, and writes it on a thread (``wait`` drains it)."""
        self.wait()
        state = _to_host(state)
        self._thread = threading.Thread(target=self._write_in_background, args=(step, state),
                                        daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Drain an in-flight background save; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self):
        steps = []
        for name in os.listdir(self.ckpt_dir):
            m = re.fullmatch(r"step_(\d+)\.pt", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int) -> Any:
        """The state saved as step ``step``, its tensors on the CPU."""
        self.wait()
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore_latest(self) -> Optional[Any]:
        self.wait()  # an in-flight save may be the latest
        step = self.latest_step()
        return None if step is None else self.restore(step)
