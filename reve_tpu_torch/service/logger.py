"""Opt-in append-file logger, gated by the config flag.

The port's copy of reve_tpu/service/logger.py, which mirrors the
reference GUI logger (reve-gui/src-tauri/src/utils.rs:5-50): appends to
`<config_dir>/reve-tpu.log` (config.config_dir(), the port's own) with a
separator line, only when `application-logs` is enabled in the service
config.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

from reve_tpu_torch.service import config as config_mod

SEPARATOR = "#" * 70


class ServiceLogger:
    def __init__(self, cfg: Optional[config_mod.ServiceConfig] = None,
                 path: Optional[str] = None):
        self.cfg = cfg or config_mod.load()
        self.path = path or os.path.join(
            config_mod.config_dir(), "reve-tpu.log"
        )

    def tail(self, lines: int = 200) -> str:
        """Last `lines` lines of the log file ('' when absent)."""
        try:
            with open(self.path) as f:
                return "".join(f.readlines()[-lines:])
        except OSError:
            return ""

    def write(self, message: str) -> bool:
        """Append a log entry; returns False when logging is disabled."""
        if not self.cfg.application_logs:
            return False
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        stamp = datetime.datetime.now().isoformat(timespec="seconds")
        with open(self.path, "a") as f:
            f.write(f"{SEPARATOR}\n[{stamp}]\n{message}\n")
        return True
