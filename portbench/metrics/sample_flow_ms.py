"""Device milliseconds per sampling call under the span ``flow.reverse``
(the whole flow inverse), read from the span window (``portbench/spans.py``)."""
from portbench.spans import span_value


def read(r):
    return span_value(r, "sample", "flow.reverse", "device_ms")
