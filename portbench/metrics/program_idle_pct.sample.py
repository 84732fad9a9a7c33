"""Share of the span window in which the card is idle while a sampling call
(the span ``second_stage.forward_sample``) is open on the calling thread:
the host's part of the idle time, the harness's left out
(``portbench/spans.py``)."""
from portbench.spans import idle_pct


def read(r):
    return idle_pct(r, "sample", "second_stage.forward_sample")
