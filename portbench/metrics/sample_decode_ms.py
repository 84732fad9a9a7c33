"""Device milliseconds per sampling call under the span
``first_stage.decode`` (the ConvGRU and SPADE frame loop), read from the
span window (``portbench/spans.py``)."""
from portbench.spans import span_value


def read(r):
    return span_value(r, "sample", "first_stage.decode", "device_ms")
