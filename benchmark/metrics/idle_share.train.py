"""The device's idle share of a step: 1 - the traced segment's device
activity (the union of its kernels, copies and fills) a step over the
untraced window's time a step. The traced segment's own length is not
the base: the tracer stretches the host's side of it (2-2.5x at b1)."""


def read(summary):
    if not summary["busy_s"] or not summary.get("unit_s"):
        return None
    return 1.0 - summary["busy_s"] / summary["units"] / summary["unit_s"]
