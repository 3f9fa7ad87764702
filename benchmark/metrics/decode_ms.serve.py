"""Device ms a request of the kernels launched inside ``Predictor.predict``
(the benchmark's ``serve.predict`` span) after the model's forward: the
decode."""


def read(summary):
    dev, n = summary["span_device_s"], summary["span_kernels"]
    if n.get("serve.predict", 0) <= n.get("model.forward", 0):
        return None
    return (dev["serve.predict"] - dev.get("model.forward", 0.0)) * 1e3 / summary["units"]
