"""Device ms a step of the kernels launched inside the port's ``forward``
and ``backward`` ranges."""


def read(summary):
    dev, n = summary["span_device_s"], summary["span_kernels"]
    if not n.get("forward", 0) + n.get("backward", 0):
        return None
    return (dev.get("forward", 0.0) + dev.get("backward", 0.0)) * 1e3 / summary["units"]
