"""Device ms a step of the kernels launched inside the port's ``targets``
and ``loss`` ranges (``ops/targets.py``, ``losses/losses.py``)."""


def read(summary):
    dev, n = summary["span_device_s"], summary["span_kernels"]
    if not n.get("targets", 0) + n.get("loss", 0):
        return None
    return (dev.get("targets", 0.0) + dev.get("loss", 0.0)) * 1e3 / summary["units"]
