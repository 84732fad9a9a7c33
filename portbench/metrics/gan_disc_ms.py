"""Device milliseconds of the two discriminator updates of a train step:
CUDA events from the step's start to its ``on_phase("ds")`` hook, the median
over the traced steps."""


def read(r):
    return r.get("disc_ms") if r.get("kind") == "train" else None
