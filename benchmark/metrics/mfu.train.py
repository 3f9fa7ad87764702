"""The whole step's share of the H100's dense bf16 peak, in %: the
frozen counter's FLOPs of one step (forward and both backward convolutions) over the
untraced window's time a step."""

from benchmark.counts import bounds


def read(summary):
    return bounds.mfu(summary)
