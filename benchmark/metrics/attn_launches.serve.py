"""Kernels a frame launched inside the port's "backbone.block_attn" and
"backbone.grid_attn" spans, in the eager forwards of ``summary["backbone"]``
(``traffic/serve_closed_maxvit.py``). None where no such span ran."""

SPANS = ("backbone.block_attn", "backbone.grid_attn")


def read(summary):
    segment = summary.get("backbone")
    if not segment:
        return None
    kernels = sum(segment["span_kernels"].get(s, 0) for s in SPANS)
    return kernels / segment["units"] / segment.get("images_per_unit", 1) if kernels else None
