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

On one card the eval forward is replayed as a CUDA graph (``ServingModel``):
the second request of a frame shape captures it, and every later one copies
its frames into the graph's input and launches the whole forward at once,
where eagerly the host launched its ~3,000 kernels one by one.

Under ``torch.profiler`` a request shows as spans (``utils/profiling.span``):
"upload" (the frames' slice and copy to the device), "forward" and
"decode" with its stages (``ops/decode.py``), and "sync:<site>" around
each point where the host waits on the device: "sync:upload" around the
frames' copy from pageable host memory, and the decode's "sync:class_offset"
and "sync:nms". Inside "forward", "graph:capture" opens around a capture and
"graph:replay" around each replay.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops.decode import DecodeConfig, Detections, forward_and_decode
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.parallel.mesh import Mesh, batch_shard
from instance_segmentation_torch.utils.profiling import NO_SPAN, span, tracing
from instance_segmentation_torch.weights import init_random, load_flax_variables


class _Graph:
    """One captured eval forward: its static input, the CUDA graph, and the
    outputs that each replay overwrites."""

    def __init__(self, forward, images: torch.Tensor):
        self.input = images.clone(memory_format=torch.contiguous_format)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):         # a side stream, a private memory pool
            self.outputs = forward(self.input)

    def replay(self, images: torch.Tensor) -> tuple:
        self.input.copy_(images)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


class ServingModel(EfficientSeg):
    """The Predictor's EfficientSeg, whose eval forward of a CUDA frame batch
    replays one CUDA graph per input shape. The first call of a shape runs
    eagerly (cuDNN and cuBLAS set themselves up), the second captures the
    forward, from the frames through the five heads, and replays it, and
    every later call copies its frames into the graph's input and replays.
    The graphs read the weights where they lie, so these stay fixed once the
    Predictor is built. Each call returns clones of the graph's outputs, which
    the caller may keep past the next call.

    A call runs eagerly where a replay would compute something else or go
    unseen: off CUDA; under a spatial mesh (its halo exchanges are
    collectives); in training or with grad enabled; and under a Python
    dispatch mode (a FLOP counter or fake tensors see only the operations
    that run, and a replay runs none)."""

    def __init__(self, cfg: EfficientSegConfig):
        super().__init__(cfg)
        self._graphs = {}       # (shape, dtype, device) -> None once seen, then its _Graph

    def eager(self, images: torch.Tensor) -> bool:
        """Whether the forward of ``images`` runs eagerly (see the class)."""
        return (not images.is_cuda or spatial.active() is not None or self.training
                or torch.is_grad_enabled() or _get_current_dispatch_mode() is not None)

    def forward(self, images: torch.Tensor):
        if self.eager(images):
            return super().forward(images)
        key = (tuple(images.shape), images.dtype, images.device)
        if key not in self._graphs:
            self._graphs[key] = None
            return super().forward(images)
        with torch.cuda.device(images.device):
            graph = self._graphs[key]
            if graph is None:
                with span("graph:capture"):
                    graph = self._graphs[key] = _Graph(super().forward, images)
            with span("graph:replay"):
                return graph.replay(images)


class Predictor:
    """``weights`` is the JAX package's ``{"params", "batch_stats"}`` tree
    (numpy leaves), or a CPU ``torch.Generator`` for seeded untrained
    weights. Frames are [B, H, W, 3] uint8 at the model input size
    ``orig_hw / scale``; detections come back at ``orig_hw``. ``cfg.quant``
    "int8" serves through the int8 path. With a ``mesh`` (on ``device``)
    ``predict`` serves this rank's share of the frames."""

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
            return forward_and_decode(self.model, images, self.anchors, self.orig_hw[0],
                                      self.orig_hw[1], self.scale, self.decode_cfg)
