"""K1: the inverse of one affine masked-conv flow (MCF), in any of its four
orders, and the cluster plan that K1 and K2 share.

Replaces the TPU kernel ``ipoke_tpu/ops/pallas/mcf_inverse.py``
(``_kernel`` / ``_call`` / ``mcf_inverse_pallas``).  CUDA source:
``csrc/mcf_inverse.cu`` with the cluster scan of ``csrc/mcf_cluster_scan.cuh``.

For each line i of the scan (A rows forward, B rows reverse, C columns
forward, D columns reverse):
    ctx  = conv(the kseq lines already inverted before i, w_shift)   (zero padded)
    raw  = act(ctx ++ h[line i]) @ w1^T + b1
    line = (z[line i] - mu) / (1 + alpha * tanh(logs / 2) + 1e-12)

What bounds it on the H100: f32 operations (the context conv and the 1x1
conv), but the lines are a dependent chain, so one launch takes the chain's
latency, far above the operation bound.  The design runs each example on a
cluster of G CTAs (grid = B * G): the hidden and h channels are split over
the G ranks, every rank keeps a copy of the latent and its share of the
weights in shared memory (staged by ``cp.async``), and the ranks exchange
their partial (mu, logs) through distributed shared memory, once per line,
summed in rank order.  Every order runs in its native orientation on z, h
and w_shift as stored.  ``cluster_plan`` picks G.

``mcf_inverse`` calls the custom op ``ipoke::mcf_inverse``
(``torch.library.Library``): its CUDA implementation launches the kernel
(``launch``), its CPU implementation is the plain version
``mcf_inverse_plain``, taken for CPU tensors only, and its fake
implementation gives ``torch.export`` the output's shape, so an exported
graph holds one ``ipoke::mcf_inverse`` node per MCF.  No autograd formula is registered: the JAX kernel has no backward
either.  Each launch adds one to the counter ``mcf.k1_launches``
(``utils/profiling``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.flows.transforms import get_transform
from ipoke_tpu_torch.nn.core import activation
from ipoke_tpu_torch.ops.cuda import _build
from ipoke_tpu_torch.utils import profiling

ORDERS = ("A", "B", "C", "D")   # conv1..conv4 of a MaCowUnit
CLUSTER_SIZES = (1, 2, 4, 8)    # portable thread-block cluster sizes on sm_90
MAX_SMEM_BYTES = 232_448        # shared memory one CTA may use on the H100
SLICES = 1                      # weight slices K1 keeps in shared memory (K2: slice_plan)


def rank_channels(g, hid, hc):
    """Per rank of a cluster of ``g``: (its hidden channels, its h channels),
    as ``range`` objects, the split of ``csrc/mcf_cluster_scan.cuh``."""
    jg, kg = hid // g, hc // g
    return [(range(r * jg, (r + 1) * jg), range(r * kg, (r + 1) * kg)) for r in range(g)]


def cluster_smem_bytes(g, c, hid, hc, kseq, kpar, height, width, slices=SLICES):
    """Shared memory of one CTA at cluster size ``g`` with ``slices`` weight
    slices: the same count as ``cluster_smem_bytes`` in
    ``csrc/mcf_cluster_scan.cuh``.  Raises ``ValueError`` for a ``g`` that is
    not a cluster size or does not divide ``hid`` and ``hc``."""
    if g not in CLUSTER_SIZES or hid % g or hc % g:
        raise ValueError(f"cluster size {g} is not in {CLUSTER_SIZES} or does not divide "
                         f"hid {hid} and hc {hc}")
    jg, kg = hid // g, hc // g
    ldc = c | 1
    ldr = (width * ldc) | 1
    hrs = (width * (kg | 1)) | 1
    p = max(height, width)
    slice_ = jg * ((c * kseq * kpar) | 1) + 2 * c * ((jg + kg) | 1) + 2 * c
    r4 = lambda n: (n + 3) // 4 * 4   # noqa: E731  every region starts on 16 bytes
    return 4 * (2 * r4(height * ldr) + r4(height * hrs if kg else 0) + r4(p * ((jg + kg) | 1))
                + r4(2 * p * 2 * c) + slices * r4(slice_))


def allowed_clusters(c, hid, hc, kseq, kpar, height, width, slices=SLICES):
    """The cluster sizes of ``CLUSTER_SIZES`` that divide ``hid`` and ``hc``
    and whose shared memory with ``slices`` weight slices fits one CTA."""
    return [g for g in CLUSTER_SIZES if hid % g == 0 and hc % g == 0
            and cluster_smem_bytes(g, c, hid, hc, kseq, kpar, height, width, slices)
            <= MAX_SMEM_BYTES]


def cluster_plan(c, hid, hc, kseq, kpar, height, width, cluster=None, slices=SLICES):
    """(G, shared bytes per CTA) for one MCF's shapes; K1 by default, K2 with
    the ``slices`` of its ``slice_plan``.

    Rule: the largest G of ``allowed_clusters``.  K1's time falls as G grows
    at every C measured, as K2's does (its sweep is in
    ``mcf_unit_inverse.cluster_plan``); ms per launch on the device, order A,
    B=8, hc=128, 8x8 latent; NVIDIA H100 80GB HBM3 at 700 W; ``python -m
    ipoke_tpu_torch.utils.kernel_bench``:

        C=32: G=1 0.157, G=2 0.088, G=4 0.053, G=8 0.039
        C=16: G=1 0.073, G=2 0.041, G=4 0.031, G=8 0.027
        C=4:  G=1 0.035, G=2 0.027, G=4 0.023, G=8 0.023
        C=64: G=4 0.140, G=8 0.085

    An explicit ``cluster`` is checked instead.  ``ValueError`` for a G that
    does not divide or does not fit, and when no G fits.
    """
    if cluster is None:
        allowed = allowed_clusters(c, hid, hc, kseq, kpar, height, width, slices)
        if not allowed:
            raise ValueError(f"no cluster size in {CLUSTER_SIZES} fits C={c}, hid={hid}, hc={hc}")
        cluster = allowed[-1]
    nbytes = cluster_smem_bytes(cluster, c, hid, hc, kseq, kpar, height, width, slices)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"cluster size {cluster}: {nbytes} bytes of shared memory per CTA "
                         f"exceed {MAX_SMEM_BYTES} (C={c}, hid={hid}, hc={hc})")
    return cluster, nbytes


def _canonical(w_shift, z, h, order):
    """Map an MCF inverse of ``order`` onto canonical order A.

    w_shift: OIHW; z, h: NHWC.  Returns (w, z, h, undo): B flips H, C swaps
    H and W, D does both (the port's counterpart of the JAX ``_canonicalize``).
    """
    if order == "A":
        return w_shift, z, h, lambda x: x
    if order == "B":
        return (w_shift.flip(2), z.flip(1), None if h is None else h.flip(1),
                lambda x: x.flip(1))
    if order == "C":
        return (w_shift.transpose(2, 3), z.transpose(1, 2),
                None if h is None else h.transpose(1, 2), lambda x: x.transpose(1, 2))
    if order == "D":
        return (w_shift.transpose(2, 3).flip(2), z.transpose(1, 2).flip(1),
                None if h is None else h.transpose(1, 2).flip(1),
                lambda x: x.flip(1).transpose(1, 2))
    raise ValueError(f"MCF order {order!r} not in {ORDERS}")


def mcf_inverse_plain(z, h, w_shift, w1, b1, order="A", alpha=1.0, act="elu", transform="affine"):
    """Plain PyTorch version of the same function as the kernel: the row loop
    of order A, with orders B/C/D mapped onto it by flips and transposes.
    ``transform`` other than the kernel's affine one is JAX's scan with that
    transform (the flows route non-affine MCFs here on every backend).

    z: (B,H,W,C); h: (B,H,W,hc) or None; w_shift: OIHW as stored, (hid, C,
    kseq, kpar) for A/B and (hid, C, kpar, kseq) for C/D; w1: (n C, hid + hc)
    for a transform of n params; b1: (n C,).  Returns (B,H,W,C), contiguous.
    """
    T = get_transform(transform)
    w_shift, z, h, undo = _canonical(w_shift, z, h, order)
    b, height, width, c = z.shape
    kh, kw = w_shift.shape[2], w_shift.shape[3]
    cw = (kw - 1) // 2
    f = activation(act)
    # output rows in NCHW with kh zero rows above and cw zero columns per side
    buf = z.new_zeros((b, c, kh + height, width + 2 * cw))
    for i in range(height):
        ctx = F.conv2d(buf[:, :, i:i + kh], w_shift)[:, :, 0].transpose(1, 2)  # (B,W,hid)
        if h is not None:
            ctx = torch.cat([ctx, h[:, i]], dim=-1)
        row, _ = T.bwd(z[:, i], T.calc_params(f(ctx) @ w1.t() + b1, alpha))
        buf[:, :, kh + i, cw:cw + width] = row.transpose(1, 2)
    return undo(buf[:, :, kh:, cw:cw + width].permute(0, 2, 3, 1)).contiguous()


def launch(z, h, w_shift, w1, b1, order="A", alpha=1.0, act="elu", cluster=None):
    """K1 on CUDA tensors, read as stored, through its ctypes binding: the
    checks, one launch, ``mcf.k1_launches`` + 1.  ``cluster`` fixes G
    (the tests and the sweep); by default ``cluster_plan`` picks it."""
    if z.device.type != "cuda":
        raise ValueError(f"mcf_inverse: no kernel for device {z.device}")
    if act not in _build.ACT_CODES:
        raise ValueError(f"mcf_inverse: activation {act!r} not in {sorted(_build.ACT_CODES)}")
    if order not in ORDERS:
        raise ValueError(f"mcf_inverse: order {order!r} not in {ORDERS}")
    dev = z.device
    _build.check_tensor("mcf_inverse z", z, dev, 4)
    b, height, width, c = z.shape
    _build.check_tensor("mcf_inverse w_shift", w_shift, dev, 4)
    hid, c_in, kh, kw = w_shift.shape
    kseq, kpar = (kh, kw) if order in "AB" else (kw, kh)
    hc = 0 if h is None else h.shape[-1]
    _build.check_tensor("mcf_inverse w1", w1, dev, 2)
    _build.check_tensor("mcf_inverse b1", b1, dev, 1)
    if h is not None:
        _build.check_tensor("mcf_inverse h", h, dev, 4)
        if tuple(h.shape[:3]) != (b, height, width):
            raise ValueError(f"mcf_inverse: h {tuple(h.shape)} does not match z {tuple(z.shape)}")
    if c_in != c or kpar % 2 == 0 or tuple(w1.shape) != (2 * c, hid + hc) \
            or tuple(b1.shape) != (2 * c,):
        raise ValueError(
            f"mcf_inverse: order {order} shapes z {tuple(z.shape)}, w_shift "
            f"{tuple(w_shift.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, hc {hc} "
            f"do not fit (the parallel kernel extent must be odd)")
    g, _ = cluster_plan(c, hid, hc, kseq, kpar, height, width, cluster)
    out = torch.empty_like(z)
    err = _build.load("mcf_inverse")(
        z.data_ptr(), None if h is None else h.data_ptr(), w_shift.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), out.data_ptr(), b, height, width, c, hid, hc,
        kseq, kpar, float(alpha), _build.ACT_CODES[act], int(order in "CD"), int(order in "BD"),
        g, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("mcf_inverse", err)
    profiling.count("mcf.k1_launches")
    return out


# ``torch.library.Library`` rather than ``custom_op``: see
# ``mcf_unit_inverse._LIB``.  Both ops share the namespace, hence FRAGMENT.
_LIB = torch.library.Library("ipoke", "FRAGMENT")
_LIB.define("mcf_inverse(Tensor z, Tensor? h, Tensor[] weights, str order, float alpha, "
            "str act, int? cluster) -> Tensor")


def _cuda_impl(z, h, weights, order, alpha, act, cluster):
    """weights: [w_shift, w1, b1]."""
    return launch(z, h, *weights, order, alpha, act, cluster)


def _cpu_impl(z, h, weights, order, alpha, act, cluster):
    return mcf_inverse_plain(z, h, *weights, order, alpha, act)


_LIB.impl("mcf_inverse", _cuda_impl, "CUDA")
_LIB.impl("mcf_inverse", _cpu_impl, "CPU")


@torch.library.register_fake("ipoke::mcf_inverse", lib=_LIB)
def _(z, h, weights, order, alpha, act, cluster):
    return torch.empty_like(z)


def mcf_inverse(z, h, w_shift, w1, b1, order="A", alpha=1.0, act="elu", cluster=None):
    """The op ``ipoke::mcf_inverse``: K1 on CUDA tensors, its plain version on
    CPU tensors."""
    return torch.ops.ipoke.mcf_inverse(z, h, [w_shift, w1, b1], order, float(alpha), act,
                                       cluster)
