"""File logger (API parity with reference QTOS/logger.py:5-45)."""

from __future__ import annotations

import os
import time


class Logger:
    """Append-only run log under a directory, `Logger(dir, name).write(...)`."""

    def __init__(self, log_dir: str = "./logs", name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.out")
        self.log = open(self.path, "a")

    def write(self, msg: str) -> None:
        stamp = time.strftime("%H:%M:%S")
        self.log.write(f"[{stamp}] {msg}\n")
        self.log.flush()

    def close(self) -> None:
        self.log.close()
