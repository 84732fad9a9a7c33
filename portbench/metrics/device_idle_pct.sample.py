"""Share of the traced sampling calls' window in which no kernel, copy or
set ran on the card."""


def read(r):
    if r.get("kind") != "sample":
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
