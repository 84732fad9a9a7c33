"""Launches of the MCF inverse kernels per sampling call: the port's
counters ``mcf.k1_launches`` plus ``mcf.k2_launches`` over its counter
``second_stage.calls``, as the process holds them when the run is read.  A
run drives one cell, so its warm-up, measured and traced calls are all of
the cell's one shape.  None for a cell of another kind, or where the port
has no such counters."""


def read(r):
    if r.get("kind") != "sample":
        return None
    from ipoke_tpu_torch.utils import profiling
    counts = getattr(profiling, "counts", lambda: {})()
    calls = counts.get("second_stage.calls", 0)
    if not calls:
        return None
    return (counts.get("mcf.k1_launches", 0) + counts.get("mcf.k2_launches", 0)) / calls
