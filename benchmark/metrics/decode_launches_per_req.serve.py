"""Kernels launched a request inside the port's "decode" span (the whole
``ops/decode.decode_output``: boxes and NMS, peaks, embeddings, grouping,
assembly)."""


def read(summary):
    if not summary["span_count"].get("decode"):
        return None
    return summary["span_kernels"]["decode"] / summary["units"]
