"""Dataset registry and batched loader (ref data/__init__.py:18-102).

Counterpart of ``instance_segmentation_tpu/data/registry.py``:
``get_dataloader`` returns an iterable of static-shape batches

    images:  uint8 [B, H, W, 3] (numpy)
    labels:  PackedLabels (padded polys/n_verts/cls_ids) or None
    infos:   list[TransInfo]

read serially, by one prefetch thread, or by a pool of ``num_workers``
worker processes, as there. ``device_prefetch`` takes the place of
``jax.device_put``: pinned host copies and ``non_blocking`` copies onto a
torch device, a few batches ahead. The ``cityscapes``, ``cityscapes_packed``,
``coco`` and ``dir`` datasets are those of the JAX registry.

The pool (the JAX package forks one each epoch) starts its workers from a
fork server (``worker_context``), never by forking this process, since a
fork after CUDA is initialised is unsafe: the server is a fresh process
that imports this package's data modules (and torch) once, and a worker
forked from it starts in milliseconds. The workers live across epochs as
long as each epoch is read to its end; an early exit stops them. A task
carries its epoch, and each worker reseeds the
dataset's transforms with ``np.random.default_rng([seed, worker, epoch])``
at its first task of an epoch, as the JAX workers do when forked. Delivery
is in order, with ``num_workers + prefetch`` batches in flight. A worker's
exception is raised in the parent as a ``RuntimeError``, and so is a
worker that dies, also in the middle of sending a batch: each worker sends
on a pipe of its own, whose only write end it holds, so its death ends the
pipe where the parent reads. Nothing falls back to serial loading. The workers hide
every CUDA device from themselves before they read anything. At exit
(``stop_fork_server``) the pools still open are stopped and then the fork
server, which would otherwise outlive this process while it exits.
"""

from __future__ import annotations

import atexit
import collections
import multiprocessing as mp
import multiprocessing.connection
import multiprocessing.forkserver
import os
import queue
import threading
import time
import traceback
import weakref
from typing import Iterator, List, Optional

import numpy as np
import torch

from instance_segmentation_torch.data import cityscapes, coco
from instance_segmentation_torch.data.cityscapes import CityscapesDatasetBuilder
from instance_segmentation_torch.data.coco import COCODatasetBuilder
from instance_segmentation_torch.data.dataset import is_train_phase
from instance_segmentation_torch.data.dir import DirDatasetBuilder
from instance_segmentation_torch.data.packed_dataset import PackedCityscapesDatasetBuilder
from instance_segmentation_torch.data.packing import PackedLabels, pack_batch

datasetBuildersMap = {
    "cityscapes": CityscapesDatasetBuilder,
    "cityscapes_packed": PackedCityscapesDatasetBuilder,
    "coco": COCODatasetBuilder,
    "dir": DirDatasetBuilder,
}

datasetClsNumMap = {
    "cityscapes": cityscapes.num_cls,
    "coco": coco.num_cls,
}

datasetEvalLabelMap = {
    "cityscapes": cityscapes.class_labels,
}


def get_eval_labels(dataset_type: str):
    return datasetEvalLabelMap[dataset_type]


def get_cls_num(dataset_type: str) -> int:
    return datasetClsNumMap[dataset_type]


HOST_HELPERS = ("png_unfilter", "warp_affine", "jpeg_codec")   # built in the parent before a pool starts
_POLL_S = 1.0                   # how often the parent checks that the workers live
_POOLS: "weakref.WeakSet[_Pool]" = weakref.WeakSet()    # pools not yet stopped


def worker_context():
    """The multiprocessing context of the data workers (and of the
    preprocessing tool's): ``forkserver``, whose server process imports this
    module, and so torch and the datasets and transforms, once."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    atexit.unregister(stop_fork_server)
    atexit.register(stop_fork_server)
    return ctx


def stop_fork_server() -> None:
    """Stop every pool still open, then the fork server of
    ``worker_context``, and wait for the server to exit: left to itself, it
    sees this process end and takes a moment more to end too. Run at exit;
    a later pool starts a new server."""
    for pool in list(_POOLS):
        pool.stop()
    multiprocessing.forkserver._forkserver._stop()


class BatchMaker:
    """Reads the dataset items of one batch and stacks them: images, packed
    labels (from ``pack_batch``, or stacked as they are when the dataset
    gives offline pre-packed labels) and infos. Pickled into each worker."""

    def __init__(self, dataset, max_instances: int, max_verts: int, with_label: bool):
        self.dataset = dataset
        self.max_instances = max_instances
        self.max_verts = max_verts
        self.with_label = with_label

    def reseed(self, seed: int, worker: int, epoch: int) -> None:
        """Give the dataset's transforms the generator of a worker in an
        epoch (JAX ``registry.py:_worker_main``)."""
        t = (getattr(self.dataset, "_transforms", None)
             or getattr(self.dataset, "transforms", None))
        if t is not None and hasattr(t, "_rng"):
            t._rng = np.random.default_rng([seed, worker, epoch])

    def __call__(self, indices) -> tuple:
        images, labels, infos = [], [], []
        for i in indices:
            img, label, info = self.dataset[i]
            images.append(np.ascontiguousarray(img))
            labels.append(label)
            infos.append(info)
        images = np.stack(images)
        packed: Optional[PackedLabels] = None
        if self.with_label and labels[0] is not None:
            if isinstance(labels[0], tuple) and len(labels[0]) == 4 \
                    and isinstance(labels[0][0], str) and labels[0][0] == "packed":
                # offline pre-packed labels (data/packed_dataset.py)
                packed = PackedLabels(
                    np.stack([l[1] for l in labels]),
                    np.stack([l[2] for l in labels]),
                    np.stack([l[3] for l in labels]))
            else:
                packed = pack_batch(labels, self.max_instances, self.max_verts)
        return images, packed, infos


def _worker_main(maker: BatchMaker, seed: int, worker: int, tasks, results) -> None:
    """A pool worker: takes (epoch, batch id, indices) until None, and sends
    (batch id, batch) or (batch id, None, the error's traceback) on its
    pipe ``results``."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    epoch = None
    while True:
        task = tasks.get()
        if task is None:
            return
        task_epoch, bid, indices = task
        try:
            if task_epoch != epoch:
                maker.reseed(seed, worker, task_epoch)
                epoch = task_epoch
            results.send((bid, maker(indices)))
        except BaseException:
            results.send((bid, None, traceback.format_exc()))
            return


class _Pool:
    """Spawned worker processes with a shared task queue and a result pipe
    each (``results[w]``: the read end; worker ``w`` holds the write end)."""

    def __init__(self, maker: BatchMaker, seed: int, num_workers: int):
        from instance_segmentation_torch.kernels import build
        build.build_all(HOST_HELPERS)
        ctx = worker_context()
        self.tasks = ctx.Queue()
        self.procs, self.results = [], []
        for w in range(num_workers):
            reader, writer = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_worker_main, args=(maker, seed, w, self.tasks, writer),
                               daemon=True, name=f"iseg-data-{w}")
            proc.start()
            writer.close()
            self.procs.append(proc)
            self.results.append(reader)
        _POOLS.add(self)

    def _died(self, proc) -> RuntimeError:
        proc.join(timeout=_POLL_S)
        return RuntimeError(f"data worker {proc.name} died (exit code {proc.exitcode}) "
                            "without delivering its batch")

    def get(self):
        """The next result; raises when a worker has died without one, or
        while sending one (its pipe ends in the middle of the message)."""
        while True:
            for conn in mp.connection.wait(self.results, timeout=_POLL_S):
                try:
                    return conn.recv()
                except (EOFError, OSError):
                    raise self._died(self.procs[self.results.index(conn)]) from None
            dead = [p for p in self.procs if not p.is_alive()]
            if dead:
                raise self._died(dead[0])

    def stop(self) -> None:
        """Ask every worker to end; results still in flight are read and
        dropped (a worker cannot exit while its last batch fills the pipe);
        a worker not gone within 10 s is killed. Stops once."""
        if self not in _POOLS:
            return
        _POOLS.discard(self)
        for _ in self.procs:
            self.tasks.put(None)
        deadline = time.monotonic() + 10.0
        open_ = list(self.results)
        while open_ and time.monotonic() < deadline:
            for conn in mp.connection.wait(open_, timeout=0.05):
                try:
                    conn.recv()
                except (EOFError, OSError):     # the worker is gone
                    open_.remove(conn)
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        for conn in self.results:
            conn.close()
        self.tasks.cancel_join_thread()
        self.tasks.close()


class BatchLoader:
    """Iterable over packed batches with optional shuffling and prefetch:
    serial (``prefetch`` 0), one prefetch thread, or ``num_workers`` forked
    worker processes (module docstring)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 max_instances: int, max_verts: int, with_label: bool = True,
                 seed: int = 0, prefetch: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._maker = BatchMaker(dataset, max_instances, max_verts, with_label)
        self._pool: Optional[_Pool] = None
        self._pool_epoch = -1

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, n, self.batch_size):
            chunk = order[s:s + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def __iter__(self) -> Iterator:
        if self.num_workers > 0:
            yield from self._iter_pool()
            return
        if self.prefetch <= 0:
            for idx in self._index_batches():
                yield self._maker(idx)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        failure: List[BaseException] = []

        def put_stop_aware(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idx in self._index_batches():
                    if stop.is_set():
                        return
                    if not put_stop_aware(self._maker(idx)):
                        return
            except BaseException as e:
                # a raising batch fails the epoch, not ends it early: a
                # swallowed error would truncate an eval sweep silently (and
                # the {epoch}_dets.json cache would pin the truncation)
                failure.append(e)
            finally:
                put_stop_aware(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if failure:
                        raise RuntimeError("data prefetch worker failed") from failure[0]
                    break
                yield item
        finally:
            # the consumer may leave the epoch early: unblock and join the
            # worker so that threads and batches do not accumulate
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)

    def _iter_pool(self) -> Iterator:
        """Ordered multi-process batch loading: the workers pull (epoch,
        batch id, indices) tasks from a shared queue and the parent reorders
        their results into the serial order."""
        if self._pool is None:
            self._pool = _Pool(self._maker, self._seed, self.num_workers)
        pool = self._pool
        self._pool_epoch += 1
        epoch = self._pool_epoch
        batches = enumerate(self._index_batches())
        inflight, limit = 0, self.num_workers + max(self.prefetch, 0)
        buf, next_out, submitted_all = {}, 0, False
        finished = False

        def submit():
            nonlocal inflight, submitted_all
            while inflight < limit and not submitted_all:
                try:
                    bid, idx = next(batches)
                except StopIteration:
                    submitted_all = True
                    return
                pool.tasks.put((epoch, bid, idx))
                inflight += 1

        try:
            submit()
            while inflight > 0 or buf:
                while next_out not in buf:
                    result = pool.get()
                    if len(result) == 3:
                        raise RuntimeError(f"data worker failed on batch {result[0]}:\n"
                                           f"{result[2]}")
                    buf[result[0]] = result[1]
                    inflight -= 1
                    submit()
                yield buf.pop(next_out)
                next_out += 1
            finished = True
        finally:
            if not finished:        # an early exit or a failure: stop the workers
                self.close()

    def close(self) -> None:
        """Stop the pool's workers (a later epoch starts new ones)."""
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool.stop()


def device_prefetch(loader, device: torch.device, size: int = 2):
    """Batches of ``loader`` with images and packed labels as tensors on
    ``device``, copied ``size`` batches ahead: from pinned host memory with
    ``non_blocking`` copies when ``device`` is a CUDA device, so that the
    copies overlap the work queued on the card."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        images, packed, infos = batch

        def move(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.pin_memory() if pin else t).to(device, non_blocking=pin)
        images = move(images)
        if packed is not None:
            packed = type(packed)(*(move(a) for a in packed))
        return images, packed, infos

    ahead = collections.deque()
    it = iter(loader)
    try:
        for batch in it:
            ahead.append(put(batch))
            if len(ahead) > size:
                yield ahead.popleft()
        while ahead:
            yield ahead.popleft()
    finally:
        # an early exit of the consumer ends the loader's prefetch thread
        if hasattr(it, "close"):
            it.close()


def get_dataloader(batch_size: int, dataset_type: str, data_dir: str, phase: str,
                   transforms=None, max_instances: int = 96, max_verts: int = 256,
                   random: bool = True, with_label: bool = True, seed: int = 0,
                   prefetch: int = 2, num_workers: Optional[int] = None) -> BatchLoader:
    """A ``BatchLoader`` over the ``dataset_type`` dataset of ``data_dir``;
    ``num_workers`` None reads ``ISEG_DATA_WORKERS`` (default 0)."""
    builder = datasetBuildersMap[dataset_type](data_dir, phase)
    dataset = builder.get_dataset(transforms=transforms)
    train = is_train_phase(phase)
    if num_workers is None:
        num_workers = int(os.environ.get("ISEG_DATA_WORKERS", "0"))
    return BatchLoader(
        dataset, batch_size,
        shuffle=train and random, drop_last=train,
        max_instances=max_instances, max_verts=max_verts,
        with_label=with_label, seed=seed, prefetch=prefetch,
        num_workers=num_workers)
