"""Device milliseconds per train step under the span ``gan.dt`` (the
temporal discriminator's loss with its gradient penalty, gradient, update
and spectral refresh), its backward on autograd's thread included
(``portbench/spans.py``)."""
from portbench.spans import span_value


def read(r):
    return span_value(r, "train", "gan.dt", "device_ms")
