"""Closed-loop serving: one client sends a request, waits for its
detections in host memory, and sends the next.

Mix parameters (``traffic/<mix>.json``): ``batch`` frames a request,
``pool`` distinct frames made from the seed and cycled in order,
``warmup`` requests made in set-up, ``checked`` requests compared with the
reference (drawn from the seed among the first pass over the pool),
``traced`` requests in the traced segment.

A request runs from a host uint8 frame batch handed to
``Predictor.predict`` to its ``Detections`` copied to host memory.
``serve_ms_p95`` is the 95th percentile of all the window's request times
and ``serve_img_per_s`` the frames completed over the window's length.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, data, harness, model, spans, trace
from benchmark.counts import bounds, flops

SOURCES = ("affinity",)   # the port's csrc/ kernels the timed path runs
HEADS = ("kp", "ae", "tan", "regression", "classification")


def _excess(gap: float, floor: float) -> float:
    """A head's gap over the stated precision's own (the floor)."""
    return gap / floor if floor > 0 else (0.0 if gap == 0 else float("inf"))


class Session:
    def __init__(self, cell, device: torch.device, seed: int, control: bool):
        from instance_segmentation_torch.ops.decode import DecodeConfig
        from instance_segmentation_torch.serve import Predictor

        self.cell, self.device, self.mix = cell, device, cell.mix
        config = cell.config
        w_seed, f_seed, s_seed = harness.sub_seeds(seed, 3)
        self.tree = model.weight_tree(config, w_seed, device)
        self.batch, self.pool = self.mix["batch"], self.mix["pool"]
        h, w = config["input_hw"]
        self.frames = data.frames(self.pool, h, w, f_seed, device)
        self.predictor = Predictor(model.program_config(config, "int8" if control else "none"),
                                   DecodeConfig(**config["decode"]), self.tree, device,
                                   tuple(config["orig_hw"]), config["scale"])
        passes = -(-self.pool // self.batch)
        rng = np.random.default_rng(s_seed)
        self.checked = set(rng.choice(passes, min(self.mix["checked"], passes),
                                      replace=False).tolist())
        self.capture = spans.HeadCapture(self.predictor.model)
        self.kept = {}
        self.unit_s = None
        for r in range(self.mix["warmup"]):
            self.request(r)

    def request_frames(self, r: int) -> np.ndarray:
        idx = [(r * self.batch + j) % self.pool for j in range(self.batch)]
        return self.frames[idx[0]:idx[0] + 1] if self.batch == 1 else self.frames[idx]

    def request(self, r: int):
        dets = self.predictor.predict(self.request_frames(r))
        return type(dets)(*(t.cpu() for t in dets))

    def window(self, seconds: float):
        times = []
        start = time.perf_counter()
        deadline = start + seconds
        r = 0
        while True:
            keep = r in self.checked
            self.capture.armed = keep
            t0 = time.perf_counter()
            dets = self.request(r)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if keep:
                self.kept[r] = (self.capture.take(), dets)
                self.checked.discard(r)
            r += 1
            if t1 >= deadline:
                break
        self.capture.armed = False
        window_s = t1 - start
        self.unit_s = window_s / r
        ms = np.asarray(times) * 1e3
        return {"metrics": {"serve_ms_p95": float(np.percentile(ms, 95)),
                            "serve_img_per_s": r * self.batch / window_s},
                "attempted": r, "failed": 0, "unit": "requests", "window_s": window_s}

    def trace(self):
        import instance_segmentation_torch.ops.decode as decode
        frames = self.request_frames(0)
        _, ops = flops.count(lambda: self.predictor.predict(frames))
        calls = []
        grouping = decode.affinity_assign

        def spy(*args):
            calls.append(args)
            return grouping(*args)

        def run():
            for r in range(self.mix["traced"]):
                with record_function(spans.PREDICT):
                    dets = self.predictor.predict(self.request_frames(r))
                type(dets)(*(t.cpu() for t in dets))
            return self.mix["traced"]

        decode.affinity_assign = spy
        try:
            with spans.model_spans(self.predictor.model):
                summary = trace.traced_segment(run, self.device)
        finally:
            decode.affinity_assign = grouping
        works = [bounds.affinity_assign(*a) for a in calls]
        summary.update(flops_per_unit=flops.total_flops(ops), unit_s=self.unit_s,
                       images_per_unit=self.batch,
                       bound_s={"affinity_assign": sum(bounds.bound(w.bytes, w.ops)[0]
                                                       for w in works) / 1e3})
        return summary

    def free(self):
        self.capture.remove()
        del self.predictor, self.capture

    def check(self):
        from benchmark.reference import decode as ref_decode
        from benchmark.reference.weights import load_flax_variables
        config = self.cell.config
        nets = []
        for stated in (False, True):    # float32, and the stated precision (the floor)
            net = model.ref.EfficientSeg(model.reference_config(config, stated))
            load_flax_variables(net, self.tree)
            nets.append(net.to(self.device).eval())
        anchors = model.anchors(config, self.device)
        decode_cfg = ref_decode.DecodeConfig(**config["decode"])
        gaps, floors, to_floor, mismatched, slots = [], [], [], 0, 0
        with compare.float32_exact(), torch.no_grad():
            for r, (heads, dets) in sorted(self.kept.items()):
                images = torch.as_tensor(self.request_frames(r)).to(self.device)
                ref_heads, floor_heads = (net(images) for net in nets)
                gaps.append([compare.rel_l2(h, g) for h, g in zip(heads, ref_heads)])
                floors.append([compare.rel_l2(h, g) for h, g in zip(floor_heads, ref_heads)])
                to_floor.append(max(compare.rel_l2(h, g) for h, g in zip(heads, floor_heads)))
                ref_dets = ref_decode.decode_output(floor_heads, anchors, *config["orig_hw"],
                                                    config["scale"], decode_cfg)
                mismatched += compare.dets_mismatch(dets, ref_dets)
                slots += dets.det_valid.numel()
        if not gaps:
            return {}
        numbers = {f"{name}_gap": max(g[i] for g in gaps) for i, name in enumerate(HEADS)}
        numbers.update(heads_gap=max(max(g) for g in gaps), dets_mismatch=mismatched / slots,
                       heads_gap_floor=max(max(f) for f in floors),
                       heads_to_floor=max(to_floor),
                       heads_excess=max(max(map(_excess, g, f)) for g, f in zip(gaps, floors)))
        return numbers


def setup(cell, device: torch.device, seed: int, control: bool = False) -> Session:
    return Session(cell, device, seed, control)
