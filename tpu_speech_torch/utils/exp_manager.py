"""Experiment manager: the log dir, environment capture, TensorBoard.

The port's own copy of what the Grad-TTS CLI uses of
``tpu_speech/utils/exp_manager.py`` (SPIRAL's nemo/utils/exp_manager.py:
105-604): it creates the log dir, records the git hash, branch and diff
(``env.json``, ``git-diff.patch``) and the config (``config.json``), and opens
a TensorBoard writer when ``tensorboardX`` is installed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any


def _git(cmd, cwd):
    try:
        return subprocess.run(
            ["git"] + cmd, cwd=cwd, capture_output=True, text=True, timeout=10
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class ExpManager:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self._capture_environment()
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(self.log_dir)

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
