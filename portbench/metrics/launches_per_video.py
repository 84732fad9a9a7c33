"""Device operations (kernels, copies, sets) in the traced calls per video
they completed."""


def read(r):
    if r.get("kind") != "sample" or not r.get("videos"):
        return None
    return r["device_ops"] / r["videos"]
