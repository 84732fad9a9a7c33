"""Model FLOPs of one sampling call (``flops.sample_call``) over the
measured window's time per call at the card's f32 peak."""
from portbench.roofline import PEAK_F32_FLOPS


def read(r):
    if r.get("kind") != "sample":
        return None
    return 100.0 * r["unit_flops"] / (r["unit_s"] * PEAK_F32_FLOPS)
