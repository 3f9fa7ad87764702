"""Training on batches resident in host memory: each step copies its batch
from pinned host memory to the card (as the port's ``device_prefetch``
does) and runs ``Trainer.step``.

Mix parameters (``traffic/<mix>.json``): ``batch`` images a step,
``instances`` labelled instances an image, ``batches`` distinct batches
made from the seed (``data.bench_train_batch``) and cycled, ``traced``
steps in the traced segment. The configuration's ``train`` group gives the
optimizer's learning rate, the instance slots and the boundary points.

Set-up builds one trainer and drives it through ``CHECKED`` steps on
distinct batches, the first steps of the window's own call and feed, then
``warmup`` more; the comparison follows the reference through the same
``CHECKED`` steps. ``train_img_per_s`` is the images of the steps
completed over the window, which ends with a device sync; the loss stats
are read one step late, as the port's epoch trainer reads them.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import compare, data, harness, model, spans, trace
from benchmark.counts import bounds, flops

SOURCES = ("rasterize", "ae_terms")   # the port's csrc/ kernels the timed path runs
CHECKED = 3
BETA1, WEIGHT_DECAY = 0.9, 1e-4          # the configuration's Adam (reference train.py)
LOSS_KERNELS = ("rasterize_cnt_r2", "rasterize_nmap", "ae_terms_fwd", "ae_terms_bwd",
                "minr2_from_cnt")


def _buffers(net) -> dict:
    return {k: b.detach().clone() for k, b in net.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


class Session:
    def __init__(self, cell, device: torch.device, seed: int, control: bool):
        config, self.mix = cell.config, cell.mix
        self.cell, self.device = cell, device
        train = config["train"]
        w_seed, d_seed, drop_seed = harness.sub_seeds(seed, 3)
        self.drop_seed = drop_seed
        self.tree = model.weight_tree(config, w_seed, device)
        h, w = config["input_hw"]
        self.host = [data.bench_train_batch(self.mix["batch"], train["max_instances"], h, w,
                                            seed=s, n_real=self.mix["instances"])
                     for s in harness.sub_seeds(d_seed, self.mix["batches"])]
        pin = device.type == "cuda"
        self.pinned = [[torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)
                        for a in (frames, *labels)] for frames, labels in self.host]
        if control:         # the reference at the stated precision, its products in float8
            from benchmark.reference.train import Trainer
            self.trainer = Trainer(model.reference_config(config, stated=True), self.tree,
                                   (h, w), train["max_points"], train["lr"], device, drop_seed,
                                   fp8=True)
        else:
            from instance_segmentation_torch.training.train_step import Trainer
            self.trainer = Trainer(model.program_config(config), self.tree, (h, w),
                                   max_points=train["max_points"], opt_type=train["optimizer"],
                                   lr=train["lr"], device=device, drop_seed=drop_seed)
        net = self.trainer.model
        start = {k: p.detach().clone() for k, p in net.named_parameters()}
        self.buffers0 = _buffers(net)
        self.losses = []
        for s in range(CHECKED):
            self.losses.append(float(self.step(s)["total_loss"]))
            if s == 0:
                state = self.trainer.optimizer.state     # no moment: the step never ran
                self.grad = {k: state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                             - WEIGHT_DECAY * start[k] for k, p in net.named_parameters()}
        self.change = {k: p.detach() - start[k] for k, p in net.named_parameters()}
        self.buffers = _buffers(net)
        del start
        for s in range(self.mix["warmup"]):
            self.step(CHECKED + s)
        self.steps = CHECKED + self.mix["warmup"]
        self.unit_s = None

    def feed(self, s: int):
        batch = self.pinned[s % len(self.pinned)]
        return [t.to(self.device, non_blocking=True) for t in batch]

    def step(self, s: int):
        return self.trainer.step(*self.feed(s))

    def window(self, seconds: float):
        sync = (torch.cuda.synchronize if self.device.type == "cuda" else lambda *_: None)
        sync(self.device)
        start = time.perf_counter()
        deadline = start + seconds
        n, late = 0, None
        while time.perf_counter() < deadline:
            stats = self.step(self.steps + n)
            if late is not None:
                float(late["total_loss"])
            late, n = stats, n + 1
        sync(self.device)
        window_s = time.perf_counter() - start
        self.steps += n
        self.unit_s = window_s / n
        return {"metrics": {"train_img_per_s": n * self.mix["batch"] / window_s},
                "attempted": n, "failed": 0, "unit": "steps", "window_s": window_s}

    def trace(self):
        from instance_segmentation_torch.kernels import ae_terms, minr2, rasterize
        _, ops = flops.count(lambda: self.step(self.steps))
        calls = {name: [] for name in LOSS_KERNELS}
        saved = []
        for module in (rasterize, ae_terms, minr2):
            for name in LOSS_KERNELS:
                if hasattr(module, name):
                    fn = getattr(module, name)
                    saved.append((module, name, fn))
                    setattr(module, name, self._spy(fn, calls[name]))

        def run():
            for s in range(self.mix["traced"]):
                with record_function(spans.STEP):
                    self.step(self.steps + 1 + s)
            return self.mix["traced"]

        try:
            with spans.model_spans(self.trainer.model):
                summary = trace.traced_segment(run, self.device)
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)
        bound_s = {}
        for name, args in calls.items():
            works = [bounds.WORK[name](*a) for a in args]
            bound_s[name] = sum(bounds.bound(w.bytes, w.ops)[0] for w in works) / 1e3
        summary.update(flops_per_unit=flops.total_flops(ops), unit_s=self.unit_s,
                       images_per_unit=self.mix["batch"], bound_s=bound_s)
        return summary

    @staticmethod
    def _spy(fn, calls):
        def spy(*args, **kwargs):
            calls.append(args)
            return fn(*args, **kwargs)
        return spy

    def free(self):
        del self.trainer, self.pinned

    def _reference(self, stated: bool):
        """(losses, first-gradient, change and batch-norm change norms) of the
        reference's ``CHECKED`` steps, in float32 or at the stated precision."""
        from benchmark.reference.train import Trainer
        config, train = self.cell.config, self.cell.config["train"]
        with compare.float32_exact():
            ref = Trainer(model.reference_config(config, stated), self.tree, config["input_hw"],
                          train["max_points"], train["lr"], self.device, self.drop_seed)
            start = {k: p.detach().clone() for k, p in ref.model.named_parameters()}
            buffers0 = _buffers(ref.model)
            losses, grad = [], {}
            for s in range(CHECKED):
                frames, labels = self.host[s % len(self.host)]
                losses.append(float(ref.step(frames, *labels)["total_loss"]))
                if s == 0:
                    grad = compare.norms({k: p.grad for k, p in ref.model.named_parameters()})
            change = compare.norms({k: p.detach() - start[k]
                                    for k, p in ref.model.named_parameters()})
            bn = compare.norms({k: b - buffers0[k] for k, b in _buffers(ref.model).items()})
        del ref
        return losses, grad, change, bn

    def check(self):
        program = (self.losses, compare.norms(self.grad), compare.norms(self.change),
                   compare.norms({k: b - self.buffers0[k] for k, b in self.buffers.items()}))
        f32 = self._reference(False)
        moving = compare.moving_leaves(f32[1])
        numbers = {}
        for tag, ref in (("", f32), ("stated_", self._reference(True))):
            loss_gaps = [abs(a - b) / abs(b) for a, b in zip(program[0], ref[0])]
            numbers.update({f"{tag}loss_gap": max(loss_gaps), f"{tag}loss_gap_first": loss_gaps[0]})
            numbers.update(compare.tree_gaps(program[1], ref[1], tag + "grad"))
            numbers.update(compare.tree_gaps(program[2], ref[2], tag + "change", moving))
            numbers.update(compare.tree_gaps(program[3], ref[3], tag + "bn"))
        return numbers


def setup(cell, device: torch.device, seed: int, control: bool = False) -> Session:
    return Session(cell, device, seed, control)
