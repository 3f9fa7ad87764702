"""Faults planted in the port's timed path, to show that the comparison
deciding ``correct`` catches them (``tests/test_faults.py`` on the CPU,
``readings.py --fault`` on the card at a cell's own size). Each is a
context manager that patches the port and restores it on exit."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def _patched(owner, name: str, value) -> Iterator[None]:
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def unchanged():
    """A training step that computes the gradients and leaves the weights as
    they were."""
    from instance_segmentation_torch.training import train_step
    return _patched(train_step.Trainer, "step", lambda self, *batch: self.compute_grads(*batch))


def half_batch():
    """A training step on the first half of the batch, its loss the mean over
    that half."""
    from instance_segmentation_torch.training import train_step
    as_batch = train_step.Trainer._as_batch

    def half(self, *batch):
        return tuple(t[: t.shape[0] // 2] for t in as_batch(self, *batch))
    return _patched(train_step.Trainer, "_as_batch", half)


def altered_loss():
    """The loss 10% off where it is produced."""
    from instance_segmentation_torch.training import train_step
    compose = train_step.compose_loss

    def altered(*args, **kwargs):
        total, stats = compose(*args, **kwargs)
        return total * 1.1, dict(stats, total_loss=stats["total_loss"] * 1.1)
    return _patched(train_step, "compose_loss", altered)


def lr_off():
    """The optimizer's learning rate 10% above the configuration's."""
    from instance_segmentation_torch.training import train_step
    make = train_step.make_optimizer

    def off(params, opt_type="Adam", lr=2e-5, momentum=0.9):
        return make(params, opt_type, lr * 1.1, momentum)
    return _patched(train_step, "make_optimizer", off)


def altered_detection():
    """The first detection slot's score of every image 1e-3 off where it is
    produced."""
    from instance_segmentation_torch import serve
    predict = serve.Predictor.predict

    def altered(self, frames):
        dets = predict(self, frames)
        bump = torch.zeros_like(dets.scores)
        bump[:, 0] = 1e-3
        return dets._replace(scores=dets.scores + bump)
    return _patched(serve.Predictor, "predict", altered)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_loss": altered_loss,
          "lr_off": lr_off, "altered_detection": altered_detection}
