"""The serving forward replayed as a CUDA graph (``serve.ServingModel``).

On the CPU: the rule that runs the forward eagerly (off CUDA, under a spatial
mesh, in training or with grad, under a dispatch mode), held on a fake CUDA
frame batch; Predictors on the CPU, under a dispatch mode (the port's FLOP
counter) and under a data 1 x spatial 2 mesh (two ranks over gloo) open no
``graph:*`` span and decode as a plain ``EfficientSeg`` does; the model keeps
the block paths that the benchmark hooks.

On the card (marked ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_serve_graph.py``): calls 1 (eager), 2 (capture) and 3
(replay) give the same heads and detections bit for bit (B0 float32 and int8
at 128x256, D3 bf16 at 512x1024); heads kept from one request survive the
next; a second batch size has its own graph; the benchmark's FLOP counter
counts the same after the capture as before it; a forward hook fires once a
request; a traced replay opens one ``graph:replay`` span inside ``forward``
and shows the graph's kernels there.

The decode's two graphs (``Predictor._decode``): on the CPU, the parts
``decode_candidates``, ``group_candidates`` and ``assemble_candidates``
compose to ``decode_output`` bit for bit (affinity and kmeans); the eager
rule is the forward's; and, with a stand-in for ``serve._Graph`` that keeps
its contract on the CPU, requests 1 (eager), 2 (captures) and 3-4 (replays)
decode as the eager decode does, with three ``graph:replay`` spans a
request and K1 called each request, and detections kept from one request
survive the next. On the card: the same at D3 shape, b1 and b8 and in
kmeans mode; detections kept survive the next request; a traced graphed
request opens three ``graph:replay`` spans and no ``sync:*`` span, launches
K1 once and the NMS kernel only inside its graph; the d3-serve cell's
Predictor at b1 and b8 launches K1 once a request, the NMS kernel from the
host once an eager request and once a capture and on the card once a
replayed request (a profiler window), and K1 there equals its CPU twin;
its b1 requests launch the batch-norm kernel (``kernels/bn_act.py``) once
a batch norm and gate from the host in the eager request and in the
capture and on the card once a replayed request, and replay the heads and
detections of a Predictor whose frozen batch norms run the composition, bit
for bit. The traced replay, and the FLOP count after a capture, are held
against an eager request whose batch norms already hold their
coefficients, which a replay never forms; after a batch norm's weight
changes in place, one eager request brings the captured graphs up to date.
"""

import collections
import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from benchmark.spans import BLOCKS
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.models.layers import BatchNorm
from instance_segmentation_torch import serve
from instance_segmentation_torch.kernels import affinity, bn_act, nms
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops.decode import DecodeConfig, forward_and_decode
from instance_segmentation_torch.parallel import multihost, spatial
from instance_segmentation_torch.parallel.mesh import Mesh, MeshSpec, batch_shard, make_mesh
from instance_segmentation_torch.serve import Predictor, ServingModel
from instance_segmentation_torch.tools.multichip import first_k1_inputs
from instance_segmentation_torch.utils import profiling
from instance_segmentation_torch.utils.flops import OpCounter, total_flops

import torch_cases
from torch_cases import cuda_device  # noqa: F401 (a fixture)

H, W = 128, 256
CPU = torch.device("cpu")
B0 = EfficientSegConfig(num_classes=8, compound_coef=0)
DECODE = DecodeConfig(kp_th=2000)


def _predictor(cfg=B0, device=CPU, hw=(H, W), mesh=None, seed=0):
    return Predictor(cfg, DECODE, torch.Generator().manual_seed(seed), device,
                     orig_hw=(2 * hw[0], 2 * hw[1]), scale=2.0, mesh=mesh)


def _frames(batch=1, hw=(H, W), seed=0):
    return np.random.default_rng(seed).integers(0, 256, (batch, *hw, 3), dtype=np.uint8)


def _plain(pred):
    """A plain ``EfficientSeg`` holding the predictor's weights: the forward
    the Predictor ran before it replayed graphs."""
    plain = EfficientSeg(pred.cfg)
    plain.load_state_dict(pred.model.state_dict())
    return plain.to(pred.device).eval()


def _identical(a, b) -> bool:
    """Equal bit for bit (NaNs included), in shape, dtype and values."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _all_identical(xs, ys) -> bool:
    return len(xs) == len(ys) and all(_identical(x, y) for x, y in zip(xs, ys))


def _span_names(prof) -> list:
    return [e.name for e in prof.events()]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_b0():
    return ServingModel(B0)


@pytest.fixture(scope="module")
def fake_cuda_frames():
    """A [1, H, W, 3] uint8 frame batch that says it lies on the card."""
    with FakeTensorMode():
        return torch.empty(1, H, W, 3, dtype=torch.uint8, device="cuda")


@pytest.mark.parametrize("case, eager", [
    ("cuda", False), ("cpu", True), ("spatial_mesh", True), ("one_rank_mesh", False),
    ("dispatch_mode", True), ("grad", True), ("training", True)])
def test_eager_rule(serving_b0, fake_cuda_frames, case, eager):
    images = torch.zeros(1, H, W, 3, dtype=torch.uint8) if case == "cpu" else fake_cuda_frames
    spatial_ranks = {"spatial_mesh": 2, "one_rank_mesh": 1}.get(case)
    mesh = None if spatial_ranks is None else Mesh(1, spatial_ranks, 0, 0, None, None, CPU)
    serving_b0.train(case == "training")
    try:
        with torch.inference_mode(case != "grad"), spatial.sharded(mesh):
            if case == "dispatch_mode":
                with OpCounter():
                    assert serving_b0.eager(images) is eager
            else:
                assert serving_b0.eager(images) is eager
    finally:
        serving_b0.eval()
    assert not serving_b0._graphs


def _three_requests(pred, frames):
    """Three requests of ``frames`` under a CPU profiler: (their detections,
    the names of the ranges they opened)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dets = [pred.predict(frames) for _ in range(3)]
    return dets, _span_names(prof)


def test_cpu_predictor_opens_no_graph_span_and_decodes_as_before():
    pred = _predictor()
    frames = _frames()
    dets, names = _three_requests(pred, frames)
    with torch.inference_mode():
        want = forward_and_decode(_plain(pred), torch.as_tensor(frames), pred.anchors,
                                  *pred.orig_hw, pred.scale, DECODE)
    assert "forward" in names and not [n for n in names if n.startswith("graph:")]
    assert all(_all_identical(d, want) for d in dets)
    assert int(want.det_valid.sum()) > 0
    assert not pred.model._graphs


def test_predictor_under_a_dispatch_mode_runs_eagerly_and_decodes_as_before():
    pred = _predictor()
    frames = _frames(seed=1)
    counted = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dets = []
        for _ in range(3):
            with OpCounter() as counter:
                dets.append(pred.predict(frames))
            counted.append(total_flops(counter.ops))
    names = _span_names(prof)
    with torch.inference_mode():
        want = forward_and_decode(_plain(pred), torch.as_tensor(frames), pred.anchors,
                                  *pred.orig_hw, pred.scale, DECODE)
    assert "forward" in names and not [n for n in names if n.startswith("graph:")]
    assert all(_all_identical(d, want) for d in dets)
    assert counted[0] > 0 and counted == counted[:1] * 3
    assert not pred.model._graphs


def _mesh_rank(rank, world, init_method, out_dir):
    torch.set_num_threads(1)
    multihost.maybe_initialize("cpu", init_method=init_method, rank=rank, world_size=world)
    try:
        mesh = make_mesh(MeshSpec(data=1, spatial=2), device_type="cpu")
        pred = _predictor(mesh=mesh)
        frames = _frames(seed=2)
        dets, names = _three_requests(pred, frames)
        with torch.inference_mode(), spatial.sharded(mesh):
            want = forward_and_decode(_plain(pred), batch_shard(torch.as_tensor(frames), mesh),
                                      pred.anchors, *pred.orig_hw, pred.scale, DECODE)
        torch.save({"dets": dets, "want": want, "names": names, "graphs": len(pred.model._graphs)},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_predictor_under_a_spatial_mesh_runs_eagerly_and_decodes_as_before(tmp_path):
    multihost.spawn(_mesh_rank, 2, (f"file://{tmp_path}/rendezvous", str(tmp_path)), timeout=600)
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        names = got["names"]
        assert "forward" in names and not [n for n in names if n.startswith("graph:")]
        assert all(_all_identical(d, got["want"]) for d in got["dets"])
        assert got["graphs"] == 0


def test_predictor_model_is_an_efficientseg_with_the_benchmarks_block_paths():
    model = _predictor().model
    assert isinstance(model, EfficientSeg)
    for path in BLOCKS.values():
        assert isinstance(model.get_submodule(path), torch.nn.Module)


# ---------------------------------------------------------------------------
# The decode's graphs, on the CPU
# ---------------------------------------------------------------------------

KMEANS = DecodeConfig(kp_th=2000, group_mode="kmeans")


def _decode_predictor(decode_cfg=DECODE, seed=0):
    return Predictor(B0, decode_cfg, torch.Generator().manual_seed(seed), CPU,
                     orig_hw=(2 * H, 2 * W), scale=2.0)


@pytest.fixture(scope="module")
def b0_heads():
    """The five heads of B0 at 128x256 on seeded weights, and the predictor."""
    pred = _decode_predictor()
    with torch.inference_mode():
        heads = pred.model(torch.as_tensor(_frames(seed=12)))
    return pred, heads


@pytest.mark.parametrize("cfg", [DECODE, KMEANS], ids=["affinity", "kmeans"])
def test_decode_parts_compose_to_decode_output(b0_heads, cfg):
    pred, heads = b0_heads
    with torch.inference_mode():
        want = decode.decode_output(heads, pred.anchors, *pred.orig_hw, pred.scale, cfg)
        cand = decode.decode_candidates(heads, pred.anchors, cfg)
        assign = decode.group_candidates(cand, cfg)
        got = decode.assemble_candidates(cand, assign, (H, W), *pred.orig_hw, pred.scale, cfg)
    assert _all_identical(got, want)
    assert int(want.obj_valid.sum()) > 0


@pytest.mark.parametrize("case, eager", [
    ("cuda", False), ("cpu", True), ("spatial_mesh", True), ("one_rank_mesh", False),
    ("dispatch_mode", True), ("grad", True)])
def test_decode_graph_eager_rule(b0_heads, fake_cuda_frames, case, eager):
    """``Predictor._decode`` runs eagerly where the forward does: the frames'
    first request of a shape is marked seen only where graphs may follow."""
    pred, heads = b0_heads
    pred._decode_graphs.clear()
    images = torch.zeros(1, H, W, 3, dtype=torch.uint8) if case == "cpu" else fake_cuda_frames
    spatial_ranks = {"spatial_mesh": 2, "one_rank_mesh": 1}.get(case)
    mesh = None if spatial_ranks is None else Mesh(1, spatial_ranks, 0, 0, None, None, CPU)
    with torch.inference_mode(case != "grad"), spatial.sharded(mesh):
        with OpCounter() if case == "dispatch_mode" else contextlib.nullcontext():
            dets = pred._decode(images, heads)
    with torch.inference_mode():
        want = decode.decode_output(heads, pred.anchors, *pred.orig_hw, pred.scale, DECODE)
    assert _all_identical(dets, want)
    assert list(pred._decode_graphs.values()) == ([] if eager else [None, None])
    pred._decode_graphs.clear()


class _EagerGraph:
    """``serve._Graph``'s contract, kept on the CPU: the capture copies its
    inputs, the outputs it makes hold junk until a replay (a capture runs
    nothing; an earlier graph's output that it passes through stays), and a
    replay copies the inputs into the static ones and recomputes into the
    same output tensors."""

    captured = 0
    made = []                   # every capture's outputs

    def __init__(self, fn, inputs):
        _EagerGraph.captured += 1
        self.fn, self.inputs = fn, tuple(t.clone() for t in inputs)
        self.outputs = fn(*self.inputs)
        for out in self.outputs:
            if not any(out is t for t in _EagerGraph.made):
                out.fill_(7)
        _EagerGraph.made += self.outputs

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        for out, fresh in zip(self.outputs, self.fn(*self.inputs)):
            if out is not fresh:
                out.copy_(fresh)
        return self.outputs


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Predictors whose CPU requests take the graphed path, through
    ``_EagerGraph``."""
    monkeypatch.setattr(serve, "_Graph", _EagerGraph)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(ServingModel, "eager", lambda self, images: False)
    _EagerGraph.captured = 0
    _EagerGraph.made = []


def _ranges(prof) -> collections.Counter:
    return collections.Counter(e.name for e in profiling.trace_events(prof)
                               if e.annotation and not e.device)


@pytest.mark.parametrize("cfg", [DECODE, KMEANS], ids=["affinity", "kmeans"])
def test_graphed_requests_decode_as_the_eager_decode(cpu_graphs, cfg, monkeypatch):
    pred = _decode_predictor(cfg, seed=1)
    frames = _frames(seed=13)
    with torch.inference_mode():
        want = forward_and_decode(_plain(pred), torch.as_tensor(frames), pred.anchors,
                                  *pred.orig_hw, pred.scale, cfg)
    assert int(want.obj_valid.sum()) > 0
    calls = []
    real = decode.affinity_assign
    monkeypatch.setattr(decode, "affinity_assign", lambda *a: calls.append(1) or real(*a))
    ranges = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dets = pred.predict(frames)
        ranges.append(_ranges(prof))
        assert _all_identical(dets, want)
    assert _EagerGraph.captured == 3 and len(calls) == 4       # K1 each request
    assert ranges[0]["graph:capture"] == ranges[0]["graph:replay"] == 0
    assert ranges[1]["graph:capture"] == ranges[1]["graph:replay"] == 3
    for r in ranges[2:]:
        assert r["graph:capture"] == 0 and r["graph:replay"] == 3
        assert r["forward"] == r["decode"] == r["decode.group"] == 1
    key = ((1, H, W, 3), torch.uint8, CPU)
    assert list(pred._decode_graphs) == [(key, "candidates"), (key, "assemble")]
    assert all(g is not None for g in pred._decode_graphs.values())


def test_graphed_detections_kept_from_a_request_survive_the_next(cpu_graphs):
    pred = _decode_predictor(seed=2)
    a, b = _frames(seed=14), _frames(seed=15)
    for _ in range(3):
        pred.predict(a)
    kept = pred.predict(a)
    copy = [t.clone() for t in kept]
    other = pred.predict(b)
    assert _all_identical(kept, copy)
    assert not _all_identical(other, kept)
    first, last = pred._decode_graphs.values()
    graph_memory = {t.data_ptr() for t in (*first.outputs, *last.outputs)}
    assert not graph_memory & {t.data_ptr() for t in kept}


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

CARD_CASES = {
    "b0-f32": (B0, (H, W)),
    "b0-int8": (EfficientSegConfig(num_classes=8, compound_coef=0, compute_dtype=torch.bfloat16,
                                   quant="int8"), (H, W)),
    "d3-bf16": (EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16),
                (512, 1024)),
    "maxvitb-bf16": (EfficientSegConfig(num_classes=8, compound_coef=3,
                                        compute_dtype=torch.bfloat16, backbone="maxvit-b"),
                     (512, 1024)),
}


class _Heads:
    """A forward hook on the model keeping each call's outputs."""

    def __init__(self, model):
        self.calls = []
        self.handle = model.register_forward_hook(lambda _m, _a, out: self.calls.append(out))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_eager_capture_and_replay_agree_bit_for_bit(cuda_device, case):
    cfg, hw = CARD_CASES[case]
    pred = _predictor(cfg, cuda_device, hw)
    heads = _Heads(pred.model)
    frames = _frames(hw=hw, seed=3)
    key = ((1, *hw, 3), torch.uint8, torch.device(cuda_device.type, torch.cuda.current_device()))
    dets = []
    for call in range(3):
        dets.append(pred.predict(frames))
        assert (pred.model._graphs[key] is None) == (call == 0)
    torch.cuda.synchronize()
    assert len(heads.calls) == 3
    for call in (1, 2):
        assert _all_identical(heads.calls[call], heads.calls[0]), f"{case}: call {call + 1}'s heads"
        assert _all_identical(dets[call], dets[0]), f"{case}: call {call + 1}'s detections"


@pytest.mark.cuda
def test_heads_kept_from_a_request_survive_the_next(cuda_device):
    pred = _predictor(device=cuda_device)
    heads = _Heads(pred.model)
    a, b = _frames(seed=4), _frames(seed=5)
    for _ in range(3):
        pred.predict(a)
    pred.predict(a)
    kept = heads.calls[-1]
    copy = [t.clone() for t in kept]
    pred.predict(b)
    torch.cuda.synchronize()
    assert _all_identical(kept, copy)
    assert not any(torch.equal(x, y) for x, y in zip(kept, heads.calls[-1]))


@pytest.mark.cuda
def test_each_batch_size_has_its_own_graph(cuda_device):
    pred = _predictor(device=cuda_device)
    heads = _Heads(pred.model)
    one, two = _frames(1, seed=6), _frames(2, seed=7)
    first = [pred.predict(one) for _ in range(3)]
    pairs = [pred.predict(two) for _ in range(3)]
    again = pred.predict(one)
    torch.cuda.synchronize()
    assert len(pred.model._graphs) == 2 and all(g is not None for g in pred.model._graphs.values())
    assert _all_identical(again, first[0]) and _all_identical(pairs[2], pairs[0])
    assert _all_identical(heads.calls[-1], heads.calls[0])


@pytest.mark.cuda
def test_flop_count_after_capture_equals_the_eager_one(cuda_device):
    from benchmark.counts import flops
    pred = _predictor(CARD_CASES["d3-bf16"][0], cuda_device, CARD_CASES["d3-bf16"][1])
    frames = _frames(hw=CARD_CASES["d3-bf16"][1], seed=8)
    with torch.inference_mode():      # the batch norms' coefficients, kept before the count
        EfficientSeg.forward(pred.model, torch.as_tensor(frames, device=cuda_device))
    _, eager_ops = flops.count(lambda: pred.predict(frames))
    pred.predict(frames)
    pred.predict(frames)
    assert all(g is not None for g in pred.model._graphs.values()) and pred.model._graphs
    assert all(g is not None for g in pred._decode_graphs.values()) and pred._decode_graphs
    _, after_ops = flops.count(lambda: pred.predict(frames))
    assert flops.total_flops(eager_ops) > 0
    assert flops.total_flops(after_ops) == flops.total_flops(eager_ops)
    assert [op.name for op in after_ops] == [op.name for op in eager_ops]


@pytest.mark.cuda
def test_an_eager_request_after_a_weight_change_brings_the_graphs_up_to_date(cuda_device):
    """The b1 graph, captured before a batch norm's weight changes in place,
    replays the new weights' heads once a b8 request has run eagerly: the
    kept coefficients it reads are rewritten where they lie."""
    pred = _predictor(device=cuda_device)
    heads = _Heads(pred.model)
    one, eight = _frames(1, seed=21), _frames(8, seed=22)
    for _ in range(3):
        pred.predict(one)                                   # eager, capture, replay
    norm = next(m for m in pred.model.modules() if isinstance(m, BatchNorm))
    with torch.no_grad():
        norm.weight.mul_(1.5)
    pred.predict(eight)
    pred.predict(one)
    torch.cuda.synchronize()
    key = ((1, H, W, 3), torch.uint8, torch.device(cuda_device.type, torch.cuda.current_device()))
    assert pred.model._graphs[key] is not None
    with torch.inference_mode():
        want = EfficientSeg.forward(pred.model, torch.as_tensor(one, device=cuda_device))
    assert _all_identical(heads.calls[-1], want)
    assert not _all_identical(heads.calls[-1], heads.calls[0])


@pytest.mark.cuda
def test_a_forward_hook_fires_once_a_request(cuda_device):
    pred = _predictor(device=cuda_device)
    heads = _Heads(pred.model)
    for r in range(5):
        pred.predict(_frames(seed=9 + r % 2))
        assert len(heads.calls) == r + 1


@pytest.mark.cuda
def test_a_traced_replay_shows_its_span_and_kernels(cuda_device):
    from benchmark import trace
    pred = _predictor(device=cuda_device)
    frames = _frames(seed=11)

    def request():
        pred.predict(frames)
        return 1
    with torch.inference_mode():      # the batch norms' coefficients, formed once, not replayed
        EfficientSeg.forward(pred.model, torch.as_tensor(frames, device=cuda_device))
    eager = trace.traced_segment(request, cuda_device)
    request()                                   # the capture
    replay = trace.traced_segment(request, cuda_device)
    assert eager["span_count"].get("graph:replay", 0) == 0
    # the forward's replay and the decode's two
    assert replay["span_count"]["graph:replay"] == 3 and "graph:capture" not in replay["span_count"]
    # the graph's kernels are launched inside "forward": the same kernels, plus
    # the copy of the frames into the graph and the five heads' clones
    assert 0 <= replay["span_kernels"]["forward"] - eager["span_kernels"]["forward"] <= 10
    assert replay["span_host_s"]["forward"] < eager["span_host_s"]["forward"]


@pytest.mark.cuda
@pytest.mark.parametrize("batch, group_mode", [(1, "affinity"), (8, "affinity"), (1, "kmeans")])
def test_decode_graphs_agree_with_the_eager_decode_at_d3(cuda_device, batch, group_mode):
    cfg, hw = CARD_CASES["d3-bf16"]
    pred = Predictor(cfg, DecodeConfig(group_mode=group_mode), torch.Generator().manual_seed(0),
                     cuda_device, orig_hw=(2 * hw[0], 2 * hw[1]), scale=2.0)
    frames = _frames(batch, hw=hw, seed=16)
    dets = [pred.predict(frames) for _ in range(4)]
    torch.cuda.synchronize()
    assert len(pred._decode_graphs) == 2
    assert all(g is not None for g in pred._decode_graphs.values())
    assert int(dets[0].obj_valid.sum()) > 0
    for call in (1, 2, 3):
        assert _all_identical(dets[call], dets[0]), f"call {call + 1}'s detections"


@pytest.mark.cuda
def test_graphed_detections_survive_the_next_request_on_the_card(cuda_device):
    pred = _predictor(device=cuda_device)
    a, b = _frames(seed=17), _frames(seed=18)
    for _ in range(3):
        pred.predict(a)
    kept = pred.predict(a)
    copy = [t.clone() for t in kept]
    other = pred.predict(b)
    torch.cuda.synchronize()
    assert _all_identical(kept, copy)
    assert not _all_identical(other, kept)


@pytest.mark.cuda
def test_a_traced_graphed_request_holds_no_host_wait_and_launches_k1(cuda_device):
    from benchmark import trace
    pred = _predictor(CARD_CASES["d3-bf16"][0], cuda_device, CARD_CASES["d3-bf16"][1])
    frames = torch.as_tensor(_frames(hw=CARD_CASES["d3-bf16"][1], seed=19)).pin_memory()

    def request():
        pred.predict(frames)
        return 1
    eager = trace.traced_segment(request, cuda_device)
    request()                                   # the captures
    k1, kernel = affinity.launches, nms.launches
    replay = trace.traced_segment(request, cuda_device)
    assert affinity.launches == k1 + 1 and nms.launches == kernel   # NMS inside the graph
    count = replay["span_count"]
    assert count["graph:replay"] == 3 and count["decode"] == count["decode.group"] == 1
    assert not [name for name in count if name.startswith("sync:")]
    assert not [name for name in eager["span_count"] if name.startswith("sync:")]
    assert "decode.boxes" not in count and "decode.assemble" not in count
    # the decode's kernels: the same, plus the copies into and out of its graphs
    assert 0 <= replay["span_kernels"]["decode"] - eager["span_kernels"]["decode"] <= 24


def _device_launches(fn, name: str, calls: int = 3) -> float:
    """Device kernels whose name holds ``name`` per call of ``fn`` (after a
    warm-up), in one profiler window: a replayed graph's kernels count one
    by one."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(name in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / calls


@pytest.mark.cuda
def test_d3_requests_launch_k1_once_and_the_nms_kernel_once_in_the_graph(cuda_device):
    cfg, hw = CARD_CASES["d3-bf16"]
    dcfg = DecodeConfig()
    pred = Predictor(cfg, dcfg, torch.Generator().manual_seed(0), cuda_device,
                     orig_hw=(2 * hw[0], 2 * hw[1]), scale=2.0)
    frames = _frames(8, hw=hw, seed=0)
    k1, host = affinity.launches, nms.launches
    with first_k1_inputs() as served:             # the eager requests
        pred.predict(frames)
    pred.predict(frames[:1])
    assert nms.launches - host == 2
    host = nms.launches
    requests = [frames[:1], frames, frames[:1], frames]      # captures, then replays
    dets = [pred.predict(x) for x in requests]
    torch.cuda.synchronize()
    assert affinity.launches - k1 == 2 + len(requests)
    assert nms.launches - host == 2
    for x, d in zip(requests, dets):
        assert tuple(d.boxes.shape) == (len(x), dcfg.max_dets, 4)
        assert tuple(d.polygons.shape) == (len(x), dcfg.max_dets, dcfg.max_poly, 2)
        assert d.poly_len.dtype == d.classes.dtype == torch.int32
        for t in (d.boxes, d.scores, d.polygons, d.centers):
            assert bool(torch.isfinite(t).all())
    for b in (1, 8):
        assert _device_launches(lambda: pred.predict(frames[:b]), "nms_kernel") == 1.0, b
    cmp = torch_cases.against_cpu_twin(*affinity.affinity_assign(*served), served)
    assert cmp["bad"] == 0 and cmp["best_ok"], cmp


@pytest.mark.cuda
def test_d3_replayed_request_launches_bn_act_once_a_norm_and_gate_as_the_composition(
        cuda_device, monkeypatch):
    """The d3-serve cell's Predictor at b1: every batch norm and gate of the
    forward launches the BN kernel from the host in the eager request and in
    the capture, and on the card once a replayed request (a profiler window,
    no host launch); the replayed heads and detections equal those of a
    Predictor on the same weights whose frozen batch norms run the
    composition (``bn_act.bn_act`` patched to its twin)."""
    cfg, hw = CARD_CASES["d3-bf16"]
    applications = len(torch_cases.bn_calls(cfg, hw))
    frames = _frames(hw=hw, seed=20)

    def served(pred):
        heads = _Heads(pred.model)
        dets = [pred.predict(frames) for _ in range(3)]     # eager, capture, replay
        torch.cuda.synchronize()
        return heads.calls[-1], dets[-1], pred
    pred = _predictor(cfg, cuda_device, hw)
    before = bn_act.launches
    pred.predict(frames)
    assert bn_act.launches - before == applications == 181 + 26
    pred.predict(frames)
    assert bn_act.launches - before == 2 * applications
    assert _device_launches(lambda: pred.predict(frames), "bn_act_kernel") == applications
    assert bn_act.launches - before == 2 * applications
    heads, dets, _ = served(pred)
    monkeypatch.setattr(bn_act, "bn_act", bn_act.bn_act_plain)
    plain_heads, plain_dets, plain = served(_predictor(cfg, cuda_device, hw))
    assert _device_launches(lambda: plain.predict(frames), "bn_act_kernel") == 0
    assert int(dets.obj_valid.sum()) > 0
    assert _all_identical(heads, plain_heads) and _all_identical(dets, plain_dets)
