"""Experiment manager: the run directory, environment capture, TensorBoard.

The port's own copy of ``tpu_speech/utils/exp_manager.py::ExpManager:27``
(SPIRAL's nemo/utils/exp_manager.py:105-604): the run directory is
``explicit_log_dir`` when given, else ``<base_dir>/<name>/run_<N>``, where
``N`` is the next free version, or the latest one when ``resume_if_exists``
(so that a resumed run finds its checkpoints). It records the git hash,
branch and diff (``env.json``, ``git-diff.patch``) and the config
(``config.json``), and opens a TensorBoard writer in ``tensorboard_dir`` (or
the run directory) when ``tensorboardX`` is installed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Optional


def _git(cmd, cwd):
    try:
        return subprocess.run(
            ["git"] + cmd, cwd=cwd, capture_output=True, text=True, timeout=10
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class ExpManager:
    def __init__(self, name: str = "exp", base_dir: str = "experiments",
                 explicit_log_dir: Optional[str] = None, resume_if_exists: bool = True,
                 tensorboard_dir: Optional[str] = None):
        if explicit_log_dir:
            self.log_dir = explicit_log_dir
        else:
            version = 0
            while os.path.exists(os.path.join(base_dir, name, f"run_{version}")):
                version += 1
            if resume_if_exists and version > 0:
                version -= 1
            self.log_dir = os.path.join(base_dir, name, f"run_{version}")
        os.makedirs(self.log_dir, exist_ok=True)
        self._capture_environment()
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(tensorboard_dir or self.log_dir)

    def _capture_environment(self):
        """Record the git hash, branch and diff and the working directory."""
        repo = os.getcwd()
        info = {
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
            "git_hash": _git(["rev-parse", "HEAD"], repo),
            "git_branch": _git(["rev-parse", "--abbrev-ref", "HEAD"], repo),
            "cwd": repo,
        }
        with open(os.path.join(self.log_dir, "env.json"), "w") as f:
            json.dump(info, f, indent=2)
        diff = _git(["diff", "HEAD"], repo)
        if diff:
            with open(os.path.join(self.log_dir, "git-diff.patch"), "w") as f:
                f.write(diff)

    def save_config(self, cfg: Any):
        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return str(o)

        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=enc)

    def close(self):
        if self.tb is not None:
            self.tb.close()
