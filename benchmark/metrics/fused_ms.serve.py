"""Device ms a frame of the kernels launched inside the port's
"backbone.fused" span (the backbone's Fused-MBConv stages), read in the
eager forwards that ``traffic/serve_closed_backbone.py`` traces after the
served requests (``summary["backbone"]``). None where no such span ran."""


def read(summary):
    segment = summary.get("backbone")
    if not segment or not segment["span_kernels"].get("backbone.fused"):
        return None
    return segment["span_device_s"]["backbone.fused"] * 1e3 / segment["units"]
