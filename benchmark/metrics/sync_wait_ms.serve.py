"""Host ms a request inside the port's "sync:<site>" spans: the time the
host spends waiting on the device (a pageable upload, NMS's condition
reads). None where the segment holds no "decode" or "upload" span."""


def read(summary):
    if not summary["span_count"].get("decode") and not summary["span_count"].get("upload"):
        return None
    host = summary["span_host_s"]
    return sum(s for name, s in host.items() if name.startswith("sync:")) * 1e3 / summary["units"]
