"""Share of the traced train steps' window in which no kernel, copy or set
ran on the card."""


def read(r):
    if r.get("kind") != "train":
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
