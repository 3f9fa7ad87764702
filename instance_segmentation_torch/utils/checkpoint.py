"""Checkpoint save and resume for a ``Trainer``, restore into a model alone
(the evaluate and test entry points), and the non-strict warm start.

Counterpart of ``instance_segmentation_tpu/utils/checkpoint.py`` (orbax there,
``torch.save`` here), with the reference's file names
``efficient_weights_{epoch:08d}.pth`` (end of an epoch) and
``efficient_weights_{epoch:04d}_{iter:04d}.pth`` (mid-epoch). A file holds
the model's ``state_dict`` (float32 master weights and batch-norm running
statistics), the optimizer's state, the step count, epoch and best_ap, and
the drop-connect and augmentation generators' states (of every rank), so
that a resumed step computes what an uninterrupted one does.

With a data-parallel trainer, ``save`` is called on every rank: rank 0
copies the state to the host and writes it in a background thread, and
``wait`` ends with a barrier, so that every rank sees the file after it.
``restore_latest`` picks the file on rank 0 and every rank restores that
one.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from instance_segmentation_torch.weights import export_flax_variables, load_flax_variables

_NAME_RE = re.compile(r"^efficient_weights_(\d{8})\.pth$|^efficient_weights_(\d{4})_(\d{4})\.pth$")


def checkpoint_name(epoch: int, iter_id: Optional[int] = None) -> str:
    if iter_id is None:
        return f"efficient_weights_{epoch:08d}.pth"
    return f"efficient_weights_{epoch:04d}_{iter_id:04d}.pth"


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Saves and restores a ``Trainer`` under ``save_dir``."""

    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None

    def save(self, trainer, epoch: int, best_ap: float, iter_id: Optional[int] = None) -> str:
        """Start writing ``trainer``'s state; returns the file's path. With a
        data-parallel trainer every rank must call it (the generators' states
        are gathered); only rank 0 writes."""
        self.wait()
        self._group = trainer.group
        drop = trainer.drop_generator.get_state()
        drops = [drop]
        if trainer.group is not None:
            drops = [None] * dist.get_world_size(trainer.group)
            dist.all_gather_object(drops, drop, group=trainer.group)
        path = os.path.join(self.save_dir, checkpoint_name(max(epoch, 0), iter_id))
        if trainer.rank != 0:
            return path
        payload = {
            "model": _to_host(trainer.model.state_dict()),
            "optimizer": _to_host(trainer.optimizer.state_dict()),
            "step": trainer.steps, "epoch": int(epoch), "best_ap": float(best_ap),
            "drop_generators": drops,
            "aug_generator": (None if trainer.aug_generator is None
                              else trainer.aug_generator.get_state()),
        }
        self._thread = threading.Thread(target=self._write, args=(payload, path), daemon=True)
        self._thread.start()
        return path

    def _write(self, payload: Dict[str, Any], path: str) -> None:
        tmp = path + ".tmp"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        except Exception as exc:            # raised again by wait()
            self._error = exc

    def wait(self) -> None:
        """Wait for the last save to be written; then, with a data-parallel
        trainer, for every rank (a barrier). Raises what the writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._group is not None:
            dist.barrier(group=self._group)
            self._group = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from error

    def list_checkpoints(self) -> List[str]:
        """Checkpoint names in training order (oldest first): by epoch, each
        epoch's iter saves before its end-of-epoch save (a plain sort would
        put every iter save after every epoch save: '0007_0999' >
        '00000007')."""
        def key(name):
            m = _NAME_RE.match(name)
            if m.group(1) is not None:                  # epoch save
                return int(m.group(1)), float("inf")
            return int(m.group(2)), int(m.group(3))     # iter save
        return sorted((n for n in os.listdir(self.save_dir) if _NAME_RE.match(n)), key=key)

    def restore_latest(self, target) -> Tuple[int, float]:
        """Restore the latest checkpoint into ``target``, a ``Trainer`` or a
        model alone (``torch.nn.Module``: its weights only, for evaluation).
        Returns (start epoch, best_ap): (0, 0.0) and the target untouched
        without one. With a data-parallel trainer every rank must call it,
        and every rank restores the file rank 0 picked."""
        names = self.list_checkpoints()
        group = None if isinstance(target, torch.nn.Module) else target.group
        if group is not None:
            picked = [names[-1] if names else None]
            dist.broadcast_object_list(picked, src=dist.get_global_rank(group, 0),
                                       group=group)
            names = [picked[0]] if picked[0] else []
        if not names:
            return 0, 0.0
        return self.restore_named(names[-1], target)

    def restore_named(self, name: str, target) -> Tuple[int, float]:
        """Restore ``name`` into ``target`` (a ``Trainer``, or a model alone:
        its ``state_dict``, strict); returns (epoch + 1, best_ap)."""
        payload = torch.load(os.path.join(self.save_dir, name), map_location="cpu",
                             weights_only=True)
        if isinstance(target, torch.nn.Module):
            target.load_state_dict(payload["model"])
            return payload["epoch"] + 1, payload["best_ap"]
        trainer = target
        trainer.model.load_state_dict(payload["model"])
        trainer.optimizer.load_state_dict(payload["optimizer"])
        trainer.steps = payload["step"]
        drops = payload["drop_generators"]
        world = 1 if trainer.group is None else dist.get_world_size(trainer.group)
        if len(drops) == world:         # else (another rank count): the fresh seeds
            trainer.drop_generator.set_state(drops[trainer.rank])
        if trainer.aug_generator is not None and payload["aug_generator"] is not None:
            trainer.aug_generator.set_state(payload["aug_generator"])
        return payload["epoch"] + 1, payload["best_ap"]


def load_pretrained(tree: Mapping, model: torch.nn.Module) -> Tuple[int, int]:
    """Non-strict warm start of ``model`` from the JAX package's
    ``{"params", "batch_stats"}`` tree (numpy leaves; a converted or
    backbone-only checkpoint): every leaf whose path and shape match the
    model's is taken, everything else keeps its value (ref train.py:119-132,
    ``load_state_dict(..., strict=False)``). Returns (n_matched, n_total
    leaves of ``tree``)."""
    counts = {"matched": 0, "total": 0}

    def n_leaves(src) -> int:
        return sum(n_leaves(v) for v in src.values()) if isinstance(src, Mapping) else 1

    def merge(dst, src):
        if not isinstance(src, Mapping):
            counts["total"] += 1
            if dst is not None and not isinstance(dst, Mapping) \
                    and tuple(np.shape(dst)) == tuple(np.shape(src)):
                counts["matched"] += 1
                return np.asarray(src).astype(np.asarray(dst).dtype)
            return dst
        if not isinstance(dst, Mapping):        # structure mismatch: unmatched
            counts["total"] += n_leaves(src)
            return dst
        out = dict(dst)
        for k, v in src.items():
            if k in dst:
                out[k] = merge(dst[k], v)
            else:
                counts["total"] += n_leaves(v)
        return out

    fresh = export_flax_variables(model)
    merged = {k: merge(fresh.get(k, {}), tree.get(k, {})) for k in ("params", "batch_stats")}
    load_flax_variables(model, merged)
    return counts["matched"], counts["total"]
