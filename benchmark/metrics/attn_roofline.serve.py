"""MaxViT's attention sub-blocks' share of their roofline, in %: their least
time on the H100 (``counts/maxvit_attn.py`` on their shapes: each
sub-block's FLOPs over the dense bf16 peak or bytes over the memory rate,
the larger, summed) over the device time of the kernels inside the port's
"backbone.block_attn" and "backbone.grid_attn" spans, in the eager forwards
of ``summary["backbone"]``. None where no such span ran."""

SPANS = ("backbone.block_attn", "backbone.grid_attn")


def read(summary):
    segment = summary.get("backbone")
    if not segment or not sum(segment["span_kernels"].get(s, 0) for s in SPANS):
        return None
    device_s = sum(segment["span_device_s"].get(s, 0.0) for s in SPANS)
    return 100.0 * segment["bound_s"]["attn"] / device_s
