"""Host waits on the device a request: the port's "sync:<site>" spans over
the requests ("sync:upload", the frames copied from pageable host memory,
``serve.py``; "sync:class_offset", a blocking copy, and "sync:nms", each
host read of NMS's loop condition, ``ops/decode.py``). 0 where the port's
"decode" or "upload" span ran and no wait did; None where neither ran (a
program without the spans)."""


def read(summary):
    count = summary["span_count"]
    if not count.get("decode") and not count.get("upload"):
        return None
    return sum(n for name, n in count.items() if name.startswith("sync:")) / summary["units"]
