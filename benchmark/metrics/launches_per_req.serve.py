"""Kernel launches a request: the traced segment's CUDA kernels over its
requests."""


def read(summary):
    return summary["launches"] / summary["units"] if summary["launches"] else None
