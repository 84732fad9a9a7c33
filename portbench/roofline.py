"""Peaks of the NVIDIA H100 SXM and the work of the masked-conv-flow (MCF)
inverse kernels, counted from their shapes (a frozen copy of the port's
``utils/kernel_bench`` arithmetic).

An FMA is 2 operations; taps that fall on zero padding are not counted.
Bytes count each input read once and each output written once: the latent,
the conditioning h, the result, and each MCF's weights.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: float32 outside the tensor cores
# (the port runs f32 with TF32 off), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

K1_KERNEL = "mcf_inverse_kernel"
K2_KERNEL = "macow_unit_inverse_kernel"


def mcf_hidden(c):
    return 4 * c if c <= 96 else min(2 * c, 512)


def mcf_flops(b, seq, par, c, hid, hc, kseq=2, kpar=3):
    cp = (kpar - 1) // 2
    seq_taps = sum(min(i, kseq) for i in range(seq))
    par_taps = sum(1 for p in range(par) for s in range(kpar) if 0 <= p + s - cp < par)
    return b * (2 * seq_taps * par_taps * c * hid + 2 * seq * par * 2 * c * (hid + hc))


def mcf_weight_floats(c, hid, hc, kseq=2, kpar=3):
    return hid * c * kseq * kpar + 2 * c * (hid + hc) + 2 * c


def bound_ms(flops, nbytes):
    """(least ms, "operations" or "bytes") on the H100 at its peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_work(b, s, c, hc):
    """(flops, bytes) of one MCF inverse (kernel K1)."""
    hid = mcf_hidden(c)
    nbytes = 4 * (2 * b * s * s * c + b * s * s * hc + mcf_weight_floats(c, hid, hc))
    return mcf_flops(b, s, s, c, hid, hc), nbytes


def k2_work(b, s, c, hc):
    """(flops, bytes) of one MaCowUnit inverse (kernel K2): four MCFs and
    two actnorms."""
    hid = mcf_hidden(c)
    nbytes = 4 * (2 * b * s * s * c + b * s * s * hc + 4 * mcf_weight_floats(c, hid, hc) + 4 * c)
    return 4 * mcf_flops(b, s, s, c, hid, hc), nbytes


def unit_inverses(level_channels, num_steps):
    """(channels, count) of the MaCowUnit inverses in one flow reverse: four
    units per MaCowStep."""
    return [(c, 4 * n) for c, n in zip(level_channels, num_steps)]


def mcf_least_ms(b, s, hc, level_channels, num_steps):
    """The least time of every MaCowUnit inverse of one reverse at batch ``b``."""
    return sum(n * bound_ms(*k2_work(b, s, c, hc))[0]
               for c, n in unit_inverses(level_channels, num_steps))
