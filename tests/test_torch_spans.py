"""The port's spans (``utils/profiling.span``) on the CPU, with a
``serve.Predictor`` of EfficientSeg-B0 at 128x256 on seeded weights
(kp_th 2000): under ``torch.profiler`` one ``predict`` opens each stage span
(the backbone's "backbone.mbconv" among them) once and "sync:nms" once per host read of NMS's loop condition (each
evaluation, the first read twice as ``while_loop_op``'s eager path reads
it); with no profiler it opens no range at all; its detections are the same
bit for bit with a profiler and without; under tracing NMS keeps its
``while_loop_op``; the train step opens its five stage ranges, and a
data-parallel step on two gloo ranks one "allreduce:bn" span per sync batch
norm each way and "allreduce:grad" spans around DDP's gradient buckets."""

import collections
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instance_segmentation_torch.models import EfficientSegConfig, layers
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.parallel import multihost
from instance_segmentation_torch.serve import Predictor
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.utils import profiling

torch.set_num_threads(2)
H, W = 128, 256
STAGES = ("upload", "forward", "decode", "decode.boxes", "decode.peaks", "decode.embed",
          "decode.group", "decode.assemble", "backbone.mbconv")   # B0: MBConv blocks alone


@pytest.fixture(scope="module")
def predictor():
    return Predictor(EfficientSegConfig(num_classes=8, compound_coef=0),
                     decode.DecodeConfig(kp_th=2000), torch.Generator().manual_seed(0),
                     torch.device("cpu"), orig_hw=(2 * H, 2 * W), scale=2.0)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (1, H, W, 3), dtype=np.uint8)


def _ranges(prof) -> collections.Counter:
    """How many times each ``record_function`` range opened in a trace."""
    return collections.Counter(e.name for e in profiling.trace_events(prof)
                               if e.annotation and not e.device)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def test_predict_opens_each_stage_span_once(predictor, frames):
    dets, ranges = _traced(lambda: predictor.predict(frames))
    assert {name: ranges[name] for name in STAGES} == dict.fromkeys(STAGES, 1)
    assert int(dets.det_valid.sum()) > 0             # NMS had boxes to sweep
    # a CPU predictor copies nothing to a card, so nothing waits but NMS's reads
    assert ranges["sync:upload"] == ranges["sync:class_offset"] == 0
    assert set(ranges) <= {*STAGES, "sync:nms"}


def test_sync_nms_spans_count_the_loop_condition(predictor, frames, monkeypatch):
    evaluated = []
    real = decode._nms_unsettled

    def counted(*args):
        evaluated.append(1)
        return real(*args)

    monkeypatch.setattr(decode, "_nms_unsettled", counted)
    _, ranges = _traced(lambda: predictor.predict(frames))
    assert len(evaluated) >= 2                       # at least one sweep and the last read
    assert ranges["sync:nms"] == len(evaluated) + 1  # the first condition is read twice


def test_predict_opens_no_range_without_a_profiler(predictor, frames, monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.tracing()
    predictor.predict(frames)
    with pytest.raises(AssertionError, match="no profiler"):
        torch.autograd.profiler.record_function("x")


def test_detections_are_the_same_with_a_profiler(predictor, frames):
    plain = predictor.predict(frames)
    traced, _ = _traced(lambda: predictor.predict(frames))
    assert plain._fields == traced._fields
    for name, a, b in zip(plain._fields, plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_nms_under_export_keeps_the_while_loop(monkeypatch):
    """Under tracing (``torch.compiler.is_compiling``) ``leader_nms`` runs its
    sweeps in ``while_loop_op`` and reads nothing on the host; eagerly it
    runs them itself, with the operator's result."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (2, 24, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 40, (2, 24, 2))
                                             .astype(np.float32)], -1))
    valid = torch.from_numpy(rng.uniform(size=(2, 24)) > 0.2)
    eager = decode.leader_nms(boxes, valid, 0.3, 16)
    called = []
    real = decode.while_loop_op

    def spy(*args):
        called.append(1)
        return real(*args)

    monkeypatch.setattr(decode, "while_loop_op", spy)
    monkeypatch.setattr(decode, "_nms_eager", None)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    looped = decode.leader_nms(boxes, valid, 0.3, 16)
    assert called == [1]
    for a, b in zip(eager, looped):
        assert torch.equal(a, b)


def test_train_step_opens_its_five_ranges():
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
    trainer = Trainer(cfg, torch.Generator().manual_seed(0), (H, W), max_points=64, lr=2e-5,
                      device=torch.device("cpu"))
    frames, labels = bench_train_batch(2, 8, H, W, n_real=4)
    batch = [torch.from_numpy(a) for a in (frames, *labels)]
    _, ranges = _traced(lambda: trainer.step(*batch))
    stages = ("targets", "forward", "loss", "backward", "optimizer")
    assert {name: ranges[name] for name in stages} == dict.fromkeys(stages, 1)


def _ddp_rank(rank, world, init_method, out_dir):
    torch.set_num_threads(1)
    multihost.maybe_initialize("cpu", init_method=init_method, rank=rank, world_size=world)
    try:
        cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
        trainer = Trainer(cfg, torch.Generator().manual_seed(0), (H, W), max_points=64,
                          lr=2e-5, device=torch.device("cpu"), group=torch.distributed.group.WORLD)
        frames, labels = bench_train_batch(2, 8, H, W, n_real=4)
        batch = [torch.from_numpy(a) for a in (frames, *labels)]
        _, ranges = _traced(lambda: trainer.step(*batch))
        n_bn = sum(isinstance(m, layers.BatchNorm) for m in trainer.model.modules())
        torch.save((dict(ranges), n_bn), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def test_ddp_step_opens_allreduce_spans(tmp_path):
    multihost.spawn(_ddp_rank, 2, (f"file://{tmp_path}/rendezvous", str(tmp_path)), timeout=300)
    for rank in range(2):
        ranges, n_bn = torch.load(tmp_path / f"rank{rank}.pt")
        assert n_bn > 100
        assert ranges["allreduce:bn"] == 2 * n_bn        # each batch norm's forward and backward
        assert ranges["allreduce:grad"] >= 1             # DDP's buckets, through the comm hook
