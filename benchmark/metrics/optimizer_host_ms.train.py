"""Host ms a step of the port's ``optimizer`` range (``Trainer.step``'s
Adam update)."""


def read(summary):
    host = summary["span_host_s"].get("optimizer")
    return None if host is None else host * 1e3 / summary["units"]
