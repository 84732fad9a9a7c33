"""K2: a whole MaCowUnit inverse in one kernel.

Replaces the TPU kernel ``ipoke_tpu/ops/pallas/mcf_unit_inverse.py``
(``_make_kernel``: ``row_scan`` / ``col_scan`` / ``kernel``; ``_call``;
``macow_unit_inverse_pallas``).  CUDA source: ``csrc/mcf_unit_inverse.cu``
with the cluster scan of ``csrc/mcf_cluster_scan.cuh``.

    actnorm2^-1 -> MCF D^-1 (columns, reverse) -> MCF C^-1 (columns, forward)
    -> actnorm1^-1 -> MCF B^-1 (rows, reverse) -> MCF A^-1 (rows, forward)

Each scan runs in its native orientation with the weights as stored (no flip
or transpose).

What bounds it on the H100: f32 operations, but the 4 x H scan lines are one
dependent chain, so a launch takes the chain's latency, far above the
operation bound.  The design runs each example on a cluster of G CTAs
(grid = B * G): the hidden and h channels are split over the G ranks, every
rank keeps a copy of the latent and its share of each MCF's weights in
shared memory (staged one MCF ahead by ``cp.async`` into a ring of two
slices, or, where two do not fit, into one slice between MCFs), and the
ranks exchange their partial (mu, logs) through distributed shared memory,
once per line, summed in rank order.  ``slice_plan`` picks the slices,
``cluster_plan`` G.

``macow_unit_inverse`` calls the custom op ``ipoke::macow_unit_inverse``
(``torch.library.Library``): its CUDA implementation launches the kernel
(``launch``), its CPU implementation is the plain version
``macow_unit_inverse_plain``, taken for CPU tensors only, and its fake
implementation gives ``torch.export`` the output's shape, so an exported
graph holds one ``ipoke::macow_unit_inverse`` node per MaCowUnit.  No
autograd formula is registered: the JAX kernel has no backward either.
Each launch adds one to the counter ``mcf.k2_launches`` (``utils/profiling``).
"""
from __future__ import annotations

import torch

from ipoke_tpu_torch.nn.core import weight_norm_materialize
from ipoke_tpu_torch.ops.cuda import _build
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1
from ipoke_tpu_torch.ops.cuda.mcf_inverse import ORDERS, mcf_inverse_plain
from ipoke_tpu_torch.utils import profiling

SLICES = 2   # the ring of weight slices: the MCF that scans and the one staged behind it


def cluster_smem_bytes(g, c, hid, hc, kseq, kpar, height, width, slices=SLICES):
    """Shared memory of one CTA of K2 at cluster size ``g`` with ``slices``
    weight slices (``mcf_inverse.cluster_smem_bytes``)."""
    return k1.cluster_smem_bytes(g, c, hid, hc, kseq, kpar, height, width, slices)


def allowed_clusters(c, hid, hc, kseq, kpar, height, width, slices=SLICES):
    """The cluster sizes K2 takes at these shapes with ``slices`` weight slices."""
    return k1.allowed_clusters(c, hid, hc, kseq, kpar, height, width, slices)


def slice_plan(c, hid, hc, kseq, kpar, height, width):
    """The weight slices K2 keeps per CTA at these shapes: 2 (the ring, each
    MCF staged while the one before scans) where two fit at some G, else 1
    (each MCF staged after the one before has scanned) where one fits.

    Two slices do not fit at the widest levels of an augmented or stacked
    flow: C=96 at 8x8 (plants_128 with 32 augment channels, MCF hidden 4C,
    hc 128) needs 391,424 bytes at G=8, one slice 229,952.  ``ValueError``
    when one slice does not fit either."""
    for slices in (SLICES, 1):
        if allowed_clusters(c, hid, hc, kseq, kpar, height, width, slices):
            return slices
    raise ValueError(f"no cluster size in {k1.CLUSTER_SIZES} fits C={c}, hid={hid}, hc={hc} "
                     f"at {height}x{width}, with one weight slice or two")


def cluster_plan(c, hid, hc, kseq, kpar, height, width, cluster=None):
    """(G, shared bytes per CTA) of K2 for one unit's shapes, with the
    slices of ``slice_plan``.

    Rule: the largest G of ``allowed_clusters`` for those slices.  The
    kernel's time falls as G grows at every C measured (ms per launch on the
    device, B=8, hc=128, 8x8 latent, two slices; NVIDIA H100 80GB HBM3 at
    700 W; ``python -m ipoke_tpu_torch.utils.kernel_bench``):

        C=32: G=2 0.319, G=4 0.196, G=8 0.143
        C=16: G=1 0.244, G=2 0.141, G=4 0.107, G=8 0.093
        C=4:  G=1 0.098, G=2 0.084, G=4 0.078, G=8 0.077
        C=64: G=8 0.325 (the only G that fits)

    A larger G shortens each rank's share of a line; the cluster barrier and
    the distributed-shared-memory reads per line grow slowly with G.  An
    explicit ``cluster`` is checked instead, at the same slices.
    ``ValueError`` for a G that does not divide or does not fit, and when no
    G fits.
    """
    slices = slice_plan(c, hid, hc, kseq, kpar, height, width)
    return k1.cluster_plan(c, hid, hc, kseq, kpar, height, width, cluster, slices)


def _actnorm_inv(x, an):
    return (x - an[1]) / (torch.exp(an[0]) + 1e-8)


def macow_unit_inverse_plain(y, h, weights, an1, an2, alpha=1.0, act="elu"):
    """Plain PyTorch version of the same function as the kernel.

    weights: 4 x (w_shift OIHW, w1 (2C, hid+hc), b1 (2C,)) of conv1..conv4
    as stored; an1, an2: (2, C) stacks of [log_scale, bias].
    """
    def mcf(x, order):
        w, w1, b1 = weights[ORDERS.index(order)]
        return mcf_inverse_plain(x, h, w, w1, b1, order, alpha, act)

    out = _actnorm_inv(y, an2)
    out = mcf(out, "D")
    out = mcf(out, "C")
    out = _actnorm_inv(out, an1)
    out = mcf(out, "B")
    return mcf(out, "A")


def launch(y, h, weights, an1, an2, alpha=1.0, act="elu", cluster=None):
    """K2 on CUDA tensors through its ctypes binding: the checks, one launch,
    ``mcf.k2_launches`` + 1.  ``cluster`` fixes G (the tests and
    the sweep); by default ``cluster_plan`` picks it."""
    if y.device.type != "cuda":
        raise ValueError(f"macow_unit_inverse: no kernel for device {y.device}")
    if act not in _build.ACT_CODES:
        raise ValueError(f"macow_unit_inverse: activation {act!r} not in {sorted(_build.ACT_CODES)}")
    dev = y.device
    _build.check_tensor("macow_unit_inverse y", y, dev, 4)
    b, height, width, c = y.shape
    hc = 0 if h is None else h.shape[-1]
    if h is not None:
        _build.check_tensor("macow_unit_inverse h", h, dev, 4)
        if tuple(h.shape[:3]) != (b, height, width):
            raise ValueError(f"macow_unit_inverse: h {tuple(h.shape)} does not match y {tuple(y.shape)}")
    hid, _, kseq, kpar = weights[0][0].shape
    ptrs = []
    for order, (w, w1, b1) in zip(ORDERS, weights):
        for name, t, nd in (("w_shift", w, 4), ("w1", w1, 2), ("b1", b1, 1)):
            _build.check_tensor(f"macow_unit_inverse {order} {name}", t, dev, nd)
        want = (hid, c, kseq, kpar) if order in "AB" else (hid, c, kpar, kseq)
        if tuple(w.shape) != want or tuple(w1.shape) != (2 * c, hid + hc) \
                or tuple(b1.shape) != (2 * c,):
            raise ValueError(
                f"macow_unit_inverse: MCF {order} shapes w_shift {tuple(w.shape)} "
                f"(want {want}), w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)} do not fit "
                f"y {tuple(y.shape)} with hc {hc}")
        ptrs += [w.data_ptr(), w1.data_ptr(), b1.data_ptr()]
    for name, an in (("an1", an1), ("an2", an2)):
        _build.check_tensor(f"macow_unit_inverse {name}", an, dev, 2)
        if tuple(an.shape) != (2, c):
            raise ValueError(f"macow_unit_inverse: {name} {tuple(an.shape)} is not (2, {c})")
    if kpar % 2 == 0:
        raise ValueError(f"macow_unit_inverse: kernel width {kpar} must be odd")
    g, _ = cluster_plan(c, hid, hc, kseq, kpar, height, width, cluster)
    slices = slice_plan(c, hid, hc, kseq, kpar, height, width)
    out = torch.empty_like(y)
    err = _build.load("mcf_unit_inverse")(
        y.data_ptr(), None if h is None else h.data_ptr(), *ptrs, an1.data_ptr(),
        an2.data_ptr(), out.data_ptr(), b, height, width, c, hid, hc, kseq, kpar,
        float(alpha), _build.ACT_CODES[act], g, slices,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("macow_unit_inverse", err)
    profiling.count("mcf.k2_launches")
    return out


# Defined and implemented through ``torch.library.Library``, not
# ``torch.library.custom_op``: the latter adds a Python autograd kernel that
# re-enters the dispatcher on every call, host time paid on each of the 200
# launches of a sampling call (PERF.md §6).
_LIB = torch.library.Library("ipoke", "FRAGMENT")
_LIB.define("macow_unit_inverse(Tensor y, Tensor? h, Tensor[] weights, Tensor an1, Tensor an2, "
            "float alpha, str act, int? cluster) -> Tensor")


def _unflat(weights):
    """weights: (w_shift, w1, b1) of conv1..conv4, flat: 12 tensors."""
    return [tuple(weights[i:i + 3]) for i in range(0, 12, 3)]


def _cuda_impl(y, h, weights, an1, an2, alpha, act, cluster):
    return launch(y, h, _unflat(weights), an1, an2, alpha, act, cluster)


def _cpu_impl(y, h, weights, an1, an2, alpha, act, cluster):
    return macow_unit_inverse_plain(y, h, _unflat(weights), an1, an2, alpha, act)


_LIB.impl("macow_unit_inverse", _cuda_impl, "CUDA")
_LIB.impl("macow_unit_inverse", _cpu_impl, "CPU")


@torch.library.register_fake("ipoke::macow_unit_inverse", lib=_LIB)
def _(y, h, weights, an1, an2, alpha, act, cluster):
    return torch.empty_like(y)


def macow_unit_inverse(y, h, weights, an1, an2, alpha=1.0, act="elu", cluster=None):
    """The op ``ipoke::macow_unit_inverse``: K2 on CUDA tensors, its plain
    version on CPU tensors.  weights: 4 x (w_shift, w1, b1)."""
    if len(weights) != 4:
        raise ValueError(f"macow_unit_inverse: {len(weights)} weight sets, want 4 (conv1..conv4)")
    return torch.ops.ipoke.macow_unit_inverse(y, h, [t for w in weights for t in w], an1, an2,
                                              float(alpha), act, cluster)


def unit_weights(unit_p):
    """(w_shift, w1, b1) of conv1..conv4 of a MaCowUnit, 1x1 convs weight-normed."""
    out = []
    for name in ("conv1", "conv2", "conv3", "conv4"):
        net = unit_p[name]["net"]
        w1 = weight_norm_materialize(net["conv1x1"]["v"], net["conv1x1"]["g"])
        out.append((net["shift_conv"]["w"], w1.reshape(w1.shape[0], -1), net["conv1x1"]["b"]))
    return out


def macow_unit_inverse_cuda(unit_p, y, h, spec):
    """The MaCowUnit inverse of ``flows.macow`` under backend ``'cuda_unit'``."""
    an1 = torch.stack([unit_p["actnorm1"]["log_scale"], unit_p["actnorm1"]["bias"]])
    an2 = torch.stack([unit_p["actnorm2"]["log_scale"], unit_p["actnorm2"]["bias"]])
    return macow_unit_inverse(y.contiguous(), None if h is None else h.contiguous(),
                              unit_weights(unit_p), an1, an2, spec.alpha, spec.activation)
