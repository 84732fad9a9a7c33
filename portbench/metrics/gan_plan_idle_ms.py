"""Milliseconds per train step in which the card is idle under the span
``gan.plan`` (the key split and the crop plan, drawn on the host)
(``portbench/spans.py``)."""
from portbench.spans import span_value


def read(r):
    return span_value(r, "train", "gan.plan", "idle_ms")
