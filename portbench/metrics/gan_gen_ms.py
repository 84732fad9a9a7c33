"""Device milliseconds of the generator update of a train step: CUDA events
from the step's ``on_phase("ds")`` hook to its ``on_phase("gen")`` hook, the
median over the traced steps."""


def read(r):
    return r.get("gen_ms") if r.get("kind") == "train" else None
