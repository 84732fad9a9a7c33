"""Model FLOPs of one stage-1 train step (``flops.gan_step``: forward,
backward and the gradient penalty's double backward) over the measured
window's time per step at the card's f32 peak."""
from portbench.roofline import PEAK_F32_FLOPS


def read(r):
    if r.get("kind") != "train":
        return None
    return 100.0 * r["unit_flops"] / (r["unit_s"] * PEAK_F32_FLOPS)
