"""Closed-loop serving (``serve_closed.py``, loaded as it stands) of a
configuration whose backbone is MaxViT: the loaded module is handed
``model_maxvit.py`` in place of ``model.py``, so the program, the weight
tree, the reference and the anchors follow the file's ``backbone``, and the
comparison fills the reference from the tree by ``reference/weights_maxvit.py``.
Mix parameters as ``serve_closed.py``'s.

``trace()`` runs the base traced segment (the served requests, their
forward a CUDA graph replay), then ``traced`` eager forwards of the served
frames under the profiler: inside a replay the port's spans do not open,
and its ``backbone.mbconv``, ``backbone.block_attn``, ``backbone.grid_attn``
and ``backbone.mlp`` spans do in an eager forward, whose kernels are those
of the replay. That segment's summary is the base summary's ``"backbone"``,
with ``images_per_unit`` and ``bound_s["attn"]``: the least time of its
forwards' attention sub-blocks (``counts/maxvit_attn.py``).

The lower-precision control (``control``) is the whole port's forward in
float8: the operands of every convolution, transposed convolution and
linear layer (``models/layers.py``'s, through its ``F``) and the attention's
q, k and v rounded to e4m3 under per-tensor scales, as a float8 GEMM takes
them (the port has no int8 path for MaxViT).
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F

from benchmark import cell, model_maxvit, trace
from benchmark.counts import maxvit_attn
from benchmark.reference import weights as ref_weights, weights_maxvit

_base = cell.load_module(Path(__file__).with_name("serve_closed.py"))
_base.model = model_maxvit
SOURCES = _base.SOURCES
E4M3_MAX = 448.0


def _e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale and back, in its dtype."""
    scale = torch.clamp_min(t.abs().amax().float(), 1e-12) / E4M3_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class _E4M3Functional:
    """``torch.nn.functional`` with both operands of each product layer
    rounded by ``_e4m3`` first (the bias is left in its dtype)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv2d(x, weight, *args, **kwargs):
        return F.conv2d(_e4m3(x), _e4m3(weight), *args, **kwargs)

    @staticmethod
    def conv_transpose2d(x, weight, *args, **kwargs):
        return F.conv_transpose2d(_e4m3(x), _e4m3(weight), *args, **kwargs)

    @staticmethod
    def linear(x, weight, *args, **kwargs):
        return F.linear(_e4m3(x), _e4m3(weight), *args, **kwargs)


class Session(_base.Session):
    def __init__(self, c, device: torch.device, seed: int, control: bool):
        self._patched = None
        if control:
            from instance_segmentation_torch.models import layers, maxvit
            attention = maxvit.attention
            self._patched = attention, layers.F
            maxvit.attention = lambda q, k, v, bias: attention(_e4m3(q), _e4m3(k), _e4m3(v), bias)
            layers.F = _E4M3Functional()
        super().__init__(c, device, seed, False)

    def trace(self):
        summary = super().trace()
        net = self.predictor.model
        eager = super(type(net), net).forward         # the forward that the graph captured
        n = self.mix["traced"]
        frames = [torch.as_tensor(self.request_frames(r)).to(self.device) for r in range(n)]

        def run():
            with torch.inference_mode():
                for images in frames:
                    eager(images)
            return n

        segment = trace.traced_segment(run, self.device)
        h, w = self.cell.config["input_hw"]
        work = maxvit_attn.sub_blocks(self.cell.config["backbone"], self.batch, h, w)
        segment.update(images_per_unit=self.batch,
                       bound_s={"attn": n * maxvit_attn.least_seconds(work)})
        summary["backbone"] = segment
        return summary

    def free(self):
        super().free()
        if self._patched is not None:
            from instance_segmentation_torch.models import layers, maxvit
            (maxvit.attention, layers.F), self._patched = self._patched, None

    def check(self):
        load = ref_weights.load_flax_variables        # serve_closed's check imports it by name
        ref_weights.load_flax_variables = weights_maxvit.load_flax_variables
        try:
            return super().check()
        finally:
            ref_weights.load_flax_variables = load


def setup(c, device: torch.device, seed: int, control: bool = False) -> Session:
    return Session(c, device, seed, control)
