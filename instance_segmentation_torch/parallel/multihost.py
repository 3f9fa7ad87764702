"""Process-group set-up for data parallelism.

Counterpart of ``instance_segmentation_tpu/parallel/multihost.py``. The JAX
package initialises ``jax.distributed`` from its environment and lets GSPMD
route the collectives; here each rank is one process, started by
``torchrun`` (or by the caller), on one device:

    torchrun --nproc_per_node N -m instance_segmentation_torch.tools.multichip

``maybe_initialize`` reads torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or takes an explicit
``init_method`` from the caller, and is a no-op without either.
The backend is chosen explicitly: NCCL for CUDA devices, gloo for the CPU or
when the caller asks for it.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_TIMEOUT = datetime.timedelta(seconds=600)       # for a collective to complete


def maybe_initialize(device_type: str = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> Optional[torch.device]:
    """Initialise the default process group and return this rank's device
    (``cuda:local_rank``, made the current device, or the CPU), or return
    None (and do nothing) when neither torchrun's variables nor an
    ``init_method`` are given.

    With an ``init_method`` (``"file://..."``, ``"tcp://host:port"``),
    ``rank`` and ``world_size`` are required; ``local_rank``
    defaults to ``rank``. ``backend`` defaults to ``nccl`` for CUDA devices
    and ``gloo`` otherwise; gloo also runs on CUDA tensors (NCCL refuses two
    ranks on one card)."""
    if init_method is None and not all(v in os.environ for v in _TORCHRUN_VARS):
        return None
    if init_method is not None:
        if rank is None or world_size is None:
            raise ValueError("an explicit init_method needs rank and world_size")
    else:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        init_method = "env://"
    local_rank = rank if local_rank is None else local_rank
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    device = torch.device(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    kwargs = dict(backend=backend, init_method=init_method, rank=rank, world_size=world_size,
                  timeout=_TIMEOUT)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    return device


def process_batch_slice(global_batch: int, group=None) -> Tuple[int, int]:
    """(start, size) of this rank's share of a global batch: the whole batch
    without an initialised process group."""
    if not dist.is_initialized():
        return 0, global_batch
    n = dist.get_world_size(group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} is not divisible by {n} ranks; "
                         "images would be silently dropped")
    per = global_batch // n
    return dist.get_rank(group) * per, per


def spawn(fn: Callable, world_size: int, args: Sequence = (), timeout: float = 600.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    (the ``spawn`` start method: the caller may have initialised CUDA) and
    wait for all of them. Raises when a process fails (its peers are then
    stopped: a rank that failed leaves them waiting in a collective) or
    when they are not all done within ``timeout`` seconds; no process is
    left running."""
    ctx = mp.start_processes(fn, (world_size, *args), nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks not done within {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
