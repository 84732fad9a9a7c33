"""Device milliseconds per train step under the span ``gan.ds`` (the
spatial discriminator's loss, gradient, update and spectral refresh), its
backward on autograd's thread included (``portbench/spans.py``)."""
from portbench.spans import span_value


def read(r):
    return span_value(r, "train", "gan.ds", "device_ms")
