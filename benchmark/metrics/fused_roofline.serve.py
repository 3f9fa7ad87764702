"""The Fused-MBConv stages' share of their roofline, in %: their least time
on the H100 (``counts/fused_mbconv.py`` on the stages' shapes: FLOPs over
the dense bf16 peak or bytes over the memory rate, the larger) over the
device time of the kernels inside the port's "backbone.fused" span, in the
eager forwards of ``summary["backbone"]``. None where no such span ran."""


def read(summary):
    segment = summary.get("backbone")
    if not segment or not segment["span_kernels"].get("backbone.fused"):
        return None
    return 100.0 * segment["bound_s"]["fused"] / segment["span_device_s"]["backbone.fused"]
