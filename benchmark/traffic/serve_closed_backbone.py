"""Closed-loop serving (``serve_closed.py``, loaded as it stands) of a
configuration whose backbone is named apart from its compound coefficient:
the loaded module is handed ``model_backbone.py`` in place of ``model.py``,
so the program, the weight tree, the reference and the anchors follow the
file's ``backbone``. Mix parameters as ``serve_closed.py``'s.

``trace()`` runs the base traced segment (the served requests, their
forward a CUDA graph replay), then ``traced`` eager forwards of the served
frames under the profiler: inside a replay the port's spans do not open,
and its ``backbone.fused`` / ``backbone.mbconv`` spans do in an eager
forward, whose kernels are those of the replay. That segment's summary is
the base summary's ``"backbone"``, with ``bound_s["fused"]``: the least time
of its forwards' Fused-MBConv stages (``counts/fused_mbconv.py``).
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark import cell, model_backbone, trace
from benchmark.counts import fused_mbconv

_base = cell.load_module(Path(__file__).with_name("serve_closed.py"))
_base.model = model_backbone
SOURCES = _base.SOURCES


class Session(_base.Session):
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
        work = fused_mbconv.fused_stages(self.cell.config["backbone"], self.batch, h, w)
        segment["bound_s"] = {"fused": n * fused_mbconv.least_seconds(work)}
        summary["backbone"] = segment
        return summary


def setup(c, device: torch.device, seed: int, control: bool = False) -> Session:
    return Session(c, device, seed, control)
