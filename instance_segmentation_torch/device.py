"""Device selection. Nothing in the package picks a device on its own: callers
pass one, and GPU entry points get it from ``require_cuda``."""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError when this process has none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to this process")
    return torch.device("cuda")


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the visible cards, as
    it prints them (one line per card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip()
