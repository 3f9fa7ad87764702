"""Device ms a request of the kernels launched inside the benchmark's
``model.forward`` span (the model's forward: backbone, BiFPN, heads, U-Net)."""


def read(summary):
    kernels = summary["span_kernels"].get("model.forward", 0)
    return summary["span_device_s"]["model.forward"] * 1e3 / summary["units"] if kernels else None
