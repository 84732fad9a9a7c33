"""Share of its roofline that the MCF inverse kernels reach in the traced
calls: the least time of every MaCowUnit inverse the reverse needs at the
cell's shapes (``roofline.k2_work``), over the device time of the kernels
named ``macow_unit_inverse_kernel`` and ``mcf_inverse_kernel``."""


def read(r):
    if r.get("kind") != "sample" or not r.get("mcf_kernel_s"):
        return None
    return 100.0 * r["mcf_least_s"] / r["mcf_kernel_s"]
