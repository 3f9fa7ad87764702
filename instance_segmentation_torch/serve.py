"""Serving entry point: a model held on one device that answers batches of
uint8 frames with decoded instances.

Counterpart of the closed-over ``infer`` of the JAX package's ``bench.py``
and ``test.py``: EfficientSeg eval forward, then the full decode, with the
weights and anchors fixed at construction.

Given a (data, spatial) mesh (``parallel/mesh.make_mesh``), every rank of
it builds the same predictor and is called with the same global frame
batch: it serves its data slice, the model running on its W slab with the
halo exchanges and gathers of ``parallel/spatial.py``, and returns that
slice's detections. Every rank of a spatial group decodes the same
gathered maps and so returns the same detections. This is the counterpart
of the JAX package's inference under a ``data x spatial`` mesh.

On one card a request replays CUDA graphs: the eval forward's
(``ServingModel``) and, around the grouping, the decode's (``Predictor``).
The second request of a frame shape captures them, and every later one
copies its frames into the forward graph's input, replays it, copies the
heads into the first decode graph's inputs (boxes, NMS by its kernel,
``kernels/nms.py``, peaks, embeddings), replays that, runs the grouping
eagerly (kernel K1, launched a request, and the Lloyd steps in kmeans mode)
and replays the second decode graph (the polygons). The host launches a
request's ~3,600 kernels in a few dozen calls, where eagerly it launched
them one by one, and waits on the card only where the frames' copy leaves
pageable memory.

Under ``torch.profiler`` a request shows as spans (``utils/profiling.span``):
"upload" (the frames' slice and copy to the device), "forward" and
"decode" with its stages (``ops/decode.py``), and "sync:upload" around the
frames' copy from pageable host memory, the one point where the host waits
on the device (an eager decode on the CPU also opens "sync:nms"). A capture
opens "graph:capture" and each replay "graph:replay", inside "forward" and
inside "decode" (three replays a request; the decode's own stage spans open
only where it runs eagerly, but for "decode.group").
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.kernels import build
from instance_segmentation_torch.ops.decode import (Candidates, DecodeConfig, Detections,
                                                    assemble_candidates, decode_candidates,
                                                    decode_output, group_candidates)
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.parallel.mesh import Mesh, batch_shard
from instance_segmentation_torch.utils.profiling import NO_SPAN, span, tracing
from instance_segmentation_torch.weights import init_random, load_flax_variables


class _Graph:
    """One captured call of ``fn`` on fixed-shape CUDA tensors: static copies
    of its inputs, the CUDA graph, and the outputs that each replay
    overwrites."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.inputs = tuple(t.clone(memory_format=torch.contiguous_format) for t in inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):         # a side stream, a private memory pool
            self.outputs = fn(*self.inputs)

    def replay(self, inputs: Sequence[torch.Tensor]):
        """Copies ``inputs`` into the static inputs and replays: the outputs."""
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        return self.outputs


class _GraphCache(dict):
    """CUDA graphs by key (the frames' shape, dtype and device), under one
    rule: a key's first ``run`` calls ``fn`` eagerly (cuDNN and cuBLAS set
    themselves up), its second captures ``fn`` and replays the graph, and
    every later one replays it. A key maps to None once seen, then to its
    ``_Graph``."""

    def run(self, key, fn: Callable, inputs: Sequence[torch.Tensor]):
        """``fn(*inputs)``, eager or replayed (spans "graph:capture" and
        "graph:replay"); a replay's outputs are the graph's own, which the
        next replay overwrites."""
        if key not in self:
            self[key] = None
            return fn(*inputs)
        with torch.cuda.device(inputs[0].device):
            if self[key] is None:
                with span("graph:capture"):
                    self[key] = _Graph(fn, inputs)
            with span("graph:replay"):
                return self[key].replay(inputs)


class ServingModel(EfficientSeg):
    """The Predictor's EfficientSeg, whose eval forward of a CUDA frame batch
    replays one CUDA graph per input shape. The first call of a shape runs
    eagerly (cuDNN and cuBLAS set themselves up), the second captures the
    forward, from the frames through the five heads, and replays it, and
    every later call copies its frames into the graph's input and replays.
    The graphs read the weights where they lie, and the batch norms'
    coefficients where the first call keeps them (``models/layers.BatchNorm``),
    so the weights stay fixed once the Predictor is built; after a change
    made in place, one eager call rewrites the kept coefficients where the
    graphs read them. Each call returns clones of the graph's outputs, which
    the caller may keep past the next call.

    A call runs eagerly where a replay would compute something else or go
    unseen: off CUDA; under a spatial mesh (its halo exchanges are
    collectives); in training or with grad enabled; and under a Python
    dispatch mode (a FLOP counter or fake tensors see only the operations
    that run, and a replay runs none)."""

    def __init__(self, cfg: EfficientSegConfig):
        super().__init__(cfg)
        self._graphs = _GraphCache()

    def eager(self, images: torch.Tensor) -> bool:
        """Whether the forward of ``images`` runs eagerly (see the class)."""
        return (not images.is_cuda or spatial.active() is not None or self.training
                or torch.is_grad_enabled() or _get_current_dispatch_mode() is not None)

    def forward(self, images: torch.Tensor):
        if self.eager(images):
            return super().forward(images)
        key = (tuple(images.shape), images.dtype, images.device)
        return tuple(t.clone() for t in self._graphs.run(key, super().forward, [images]))


class Predictor:
    """``weights`` is the JAX package's ``{"params", "batch_stats"}`` tree
    (numpy leaves), or a CPU ``torch.Generator`` for seeded untrained
    weights. Frames are [B, H, W, 3] uint8 at the model input size
    ``orig_hw / scale``; detections come back at ``orig_hw``. ``cfg.quant``
    "int8" serves through the int8 path. With a ``mesh`` (on ``device``)
    ``predict`` serves this rank's share of the frames.

    Where the forward replays its graph (``ServingModel.eager`` is false),
    the decode replays two, one set per frame shape, captured on the shape's
    second request: ``decode_candidates`` (boxes, NMS, peaks, embeddings),
    then, after ``group_candidates`` runs eagerly, ``assemble_candidates``.
    The detections returned are clones, which the caller may keep past the
    next request. Elsewhere the decode runs eagerly (``decode_output``)."""

    def __init__(self, cfg: EfficientSegConfig, decode_cfg: DecodeConfig,
                 weights: Union[Mapping, torch.Generator], device: torch.device,
                 orig_hw: Tuple[int, int], scale: float, mesh: Optional[Mesh] = None):
        self.cfg, self.decode_cfg = cfg, decode_cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.orig_hw, self.scale = tuple(orig_hw), float(scale)
        self.input_hw = tuple(int(round(s / self.scale)) for s in self.orig_hw)
        model = ServingModel(cfg)
        if isinstance(weights, torch.Generator):
            init_random(model, weights)
        else:
            load_flax_variables(model, weights)
        self.model = model.to(self.device).eval()
        anchors = generate_anchors(*self.input_hw, pyramid_levels=cfg.pyramid_levels,
                                   anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                   ratios=cfg.ratios)
        self.anchors = torch.tensor(anchors, device=self.device)
        self._decode_graphs = _GraphCache()   # keys (the frames' key, "candidates" | "assemble")
        if self.device.type == "cuda":
            build.build_all(("affinity", "nms", "bn_act"))   # K1, NMS, BN, compiled at once

    def _pageable(self, images: torch.Tensor) -> bool:
        """Whether, while a profiler records, ``images``' copy to the device
        leaves pageable host memory, which makes the host wait."""
        return (tracing() and self.device.type == "cuda" and images.device.type == "cpu"
                and not images.is_pinned())

    @torch.inference_mode()
    def predict(self, frames: Union[np.ndarray, torch.Tensor]) -> Detections:
        """[B, H, W, 3] uint8 frames -> Detections on the predictor's device
        (with a mesh: of this rank's data slice of the B frames)."""
        images = torch.as_tensor(frames)
        if images.dtype != torch.uint8 or tuple(images.shape[1:]) != (*self.input_hw, 3):
            raise ValueError(f"want uint8 [B, {self.input_hw[0]}, {self.input_hw[1]}, 3] "
                             f"frames, got {images.dtype} {tuple(images.shape)}")
        with span("upload"):
            if self.mesh is not None:
                images = batch_shard(images, self.mesh)
            with span("sync:upload") if self._pageable(images) else NO_SPAN:
                images = images.to(self.device, non_blocking=True)
        with spatial.sharded(self.mesh):
            with span("forward"):
                heads = self.model(images)
            return self._decode(images, heads)

    def _decode(self, images: torch.Tensor, heads: tuple) -> Detections:
        """The decode of ``heads``, eager or by the shape's graphs (see the
        class)."""
        args = (*self.orig_hw, self.scale, self.decode_cfg)
        if self.model.eager(images):
            return decode_output(heads, self.anchors, *args)
        key = (tuple(images.shape), images.dtype, images.device)
        kp, ae, _tan, regression, classification = heads
        cfg, in_hw = self.decode_cfg, tuple(kp.shape[1:3])
        with span("decode"):
            cand = Candidates(*self._decode_graphs.run(
                (key, "candidates"),
                lambda k, a, r, c: decode_candidates((k, a, None, r, c), self.anchors, cfg),
                (kp, ae, regression, classification)))
            assign = group_candidates(cand, cfg)
            # a replayed ``cand`` is the first graph's outputs, which the capture reads in place
            dets = self._decode_graphs.run(
                (key, "assemble"), lambda a: assemble_candidates(cand, a, in_hw, *args), (assign,))
        return Detections(*(t.clone() for t in dets))
