"""The whole request's share of the H100's dense bf16 peak, in %: the
frozen counter's FLOPs of one request (forward and decode) over the
untraced window's time a request."""

from benchmark.counts import bounds


def read(summary):
    return bounds.mfu(summary)
