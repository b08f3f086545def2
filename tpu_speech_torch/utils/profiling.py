"""Profiler traces and step timing: the port's counterparts of ``trace`` and
``StepTimer`` of ``tpu_speech/utils/profiling.py:19,33`` (``StepTimer`` has
the role of DiffVC's speaker-encoder Profiler,
speaker_encoder/utils/profiler.py:1-46)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (the host, and the card when
    there is one) into ``<log_dir>/plugins/profile``, where TensorBoard's
    profile tab finds it, as ``jax.profiler.start_trace(log_dir)`` writes its
    trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(log_dir, "plugins", "profile")
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(out)) as prof:
        yield prof


class StepTimer:
    """Rolling step-time statistics on the host clock."""

    def __init__(self):
        self._t: Dict[str, float] = {}
        self._acc = defaultdict(list)

    def tick(self, name: str):
        self._t[name] = time.perf_counter()

    def tock(self, name: str):
        if name in self._t:
            self._acc[name].append(time.perf_counter() - self._t.pop(name))

    @contextlib.contextmanager
    def measure(self, name: str, sync: Optional[torch.device] = None):
        """Time the block; with ``sync`` (a CUDA device) the time ends after
        ``torch.cuda.synchronize(sync)``, where the JAX original waits with
        ``block_until_ready``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                torch.cuda.synchronize(sync)
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._acc.items():
            n = len(vals)
            out[name] = {"mean_s": sum(vals) / n, "min_s": min(vals), "max_s": max(vals),
                         "count": n}
        return out
