"""Device ms a frame of the kernels launched inside the port's
"backbone.block_attn" and "backbone.grid_attn" spans (MaxViT's attention
sub-blocks: norm, partition, QKV, attention, projection, inverse partition,
residual), read in the eager forwards that ``traffic/serve_closed_maxvit.py``
traces after the served requests (``summary["backbone"]``). None where no
such span ran."""

SPANS = ("backbone.block_attn", "backbone.grid_attn")


def read(summary):
    segment = summary.get("backbone")
    if not segment or not sum(segment["span_kernels"].get(s, 0) for s in SPANS):
        return None
    device_s = sum(segment["span_device_s"].get(s, 0.0) for s in SPANS)
    return device_s * 1e3 / segment["units"] / segment.get("images_per_unit", 1)
