"""CUDA graph replays a request: the port's "graph:replay" spans (one around
each replay of the eval forward's graph, ``serve.py``) over the requests.
0 where the port's "forward" span ran and no replay did (an eager forward);
None where no "forward" span ran (a program without the spans)."""


def read(summary):
    count = summary["span_count"]
    if not count.get("forward"):
        return None
    return count.get("graph:replay", 0) / summary["units"]
