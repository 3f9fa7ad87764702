"""Console + file + scalar-summary logging; a copy of
``instance_segmentation_tpu/utils/logger.py``.

Same capability surface as the reference logger (reference: utils/logger.py
:21-110 — timestamped console/file lines, run-config dump, TensorBoard scalar
summaries, singleton init/get). Scalars go to BOTH a metrics JSONL (the
primary machine-readable channel) and a real TensorBoard event file
(utils/tb_writer.py — dependency-free writer, loads in stock TensorBoard).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional


class Logger:
    """Timestamped logger writing to stdout, a log file, and a metrics JSONL."""

    _instance: Optional["Logger"] = None

    def __init__(self, save_dir: Optional[str] = None, level: int = 0, run_config: Any = None):
        self.level = level
        self.save_dir = save_dir
        self._file = None
        self._metrics = None
        self._tb = None
        if save_dir is not None:
            log_dir = os.path.join(save_dir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "log.txt"), "a")
            self._metrics = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            from instance_segmentation_torch.utils.tb_writer import SummaryWriter
            self._tb = SummaryWriter(log_dir)
            if run_config is not None:
                with open(os.path.join(log_dir, "opt.txt"), "w") as f:
                    if hasattr(run_config, "to_dict"):
                        run_config = run_config.to_dict()
                    f.write(json.dumps(run_config, indent=2, default=str))

    # -- singleton surface (ref logger.py:100-110) --------------------------
    @classmethod
    def init_logger(cls, save_dir: Optional[str] = None, run_config: Any = None, level: int = 0) -> "Logger":
        cls._instance = cls(save_dir, level=level, run_config=run_config)
        return cls._instance

    @classmethod
    def get_logger(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- text channel --------------------------------------------------------
    def write(self, msg: str = "", end: str = "\n", level: int = 0) -> None:
        if level > self.level:
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}" if msg else msg
        sys.stdout.write(line + end)
        sys.stdout.flush()
        if self._file is not None:
            self._file.write(line + end)
            self._file.flush()

    # -- scalar channel (ref logger.py:61-75) --------------------------------
    def scalar_summary(self, tag: str, value: float, step: int) -> None:
        if self._metrics is not None:
            self._metrics.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}) + "\n")
            self._metrics.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
            self._tb.flush()

    def close(self) -> None:
        for f in (self._file, self._metrics, self._tb):
            if f is not None:
                f.close()
        self._file = self._metrics = self._tb = None
