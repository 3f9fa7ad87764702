"""Host ms a request of the port's "forward" span (``forward_and_decode``'s
call of the model: the eager launches of its kernels, or the copy of the
frames into a CUDA graph, its replay and the copies of its outputs)."""


def read(summary):
    if not summary["span_count"].get("forward"):
        return None
    return summary["span_host_s"]["forward"] * 1e3 / summary["units"]
