"""The benchmark's own spans around the calls into each layer of the port.

``model_spans`` opens a ``torch.profiler`` range around the model's forward
(``model.forward``) and each of its blocks (``model.backbone``,
``model.bifpn``, ``model.regressor``, ``model.classifier``, ``model.unet``)
through module hooks; the traffic drivers open ``serve.predict`` around
``Predictor.predict`` and ``train.step`` around ``Trainer.step``. A range
costs nothing while no profiler records, and the hooks are installed only
for a traced segment. The port's own ranges (``targets``, ``forward``,
``loss``, ``backward``, ``optimizer``) are read as they stand.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from torch import nn
from torch.profiler import record_function

PREDICT = "serve.predict"
STEP = "train.step"
FORWARD = "model.forward"
BLOCKS = {"backbone": "backbone_net.model", "bifpn": "bifpn", "regressor": "regressor",
          "classifier": "classifier", "unet": "kp_header"}


@contextlib.contextmanager
def model_spans(model: nn.Module) -> Iterator[None]:
    """Ranges around ``model``'s forward and its blocks while inside."""
    open_ranges = {}
    handles = []

    def add(module: nn.Module, name: str):
        def pre(_module, _args):
            span = record_function(name)
            span.__enter__()
            open_ranges.setdefault(name, []).append(span)

        def post(_module, _args, _out):
            open_ranges[name].pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(pre))
        handles.append(module.register_forward_hook(post, always_call=True))

    add(model, FORWARD)
    for block, path in BLOCKS.items():
        add(model.get_submodule(path), f"model.{block}")
    try:
        yield
    finally:
        for h in handles:
            h.remove()


class HeadCapture:
    """A forward hook on the model that keeps a reference to its outputs (the
    five heads) of the calls made while ``armed``: no copy, no sync."""

    def __init__(self, model: nn.Module):
        self.armed = False
        self.outputs = None
        self._handle = model.register_forward_hook(self._hook)

    def _hook(self, _module, _args, out):
        if self.armed:
            self.outputs = out

    def take(self):
        out, self.outputs = self.outputs, None
        return out

    def remove(self) -> None:
        self._handle.remove()
