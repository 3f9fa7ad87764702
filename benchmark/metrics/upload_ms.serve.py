"""Host ms a request of the port's "upload" span (``Predictor.predict``'s
slice of the frames and their copy to the device)."""


def read(summary):
    if not summary["span_count"].get("upload"):
        return None
    return summary["span_host_s"]["upload"] * 1e3 / summary["units"]
