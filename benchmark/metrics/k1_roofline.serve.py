"""K1's (``csrc/affinity.cu``) share of its roofline, in %: its least time on
the H100 (``counts/bounds.py`` on each call's own inputs) over the device
time of its kernels in the traced segment."""

from benchmark.counts import bounds


def read(summary):
    return bounds.roofline_share(summary, ("affinity_assign",))
