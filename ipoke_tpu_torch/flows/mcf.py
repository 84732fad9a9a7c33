"""Masked Convolutional Flow (counterpart of ``ipoke_tpu/flows/mcf.py``).

The forward (density) direction is one shifted-conv pass.  The inverse is a
recurrence along one spatial axis (rows for orders A/B, columns for C/D).
Backends:

  'scan'  the plain PyTorch row loop (``ops/cuda/mcf_inverse.mcf_inverse_plain``),
          the counterpart of the JAX ``_row_scan_inverse``; orders B/C/D map
          onto order A by flips and transposes inside it;
  'cuda'  kernel K1 for each MCF (the counterpart of JAX ``'pallas'``), which
          runs every order in its native orientation on z, h and the weights
          as stored: nothing is flipped, transposed or copied on the way.

The JAX scan hoists the conditioning half of the 1x1 conv out of the loop;
the port's loop keeps the concatenated form of the kernel.  Both are the same
sum, grouped differently (~1 ulp).
"""
from __future__ import annotations

from ipoke_tpu_torch.flows import convnets
from ipoke_tpu_torch.flows.transforms import get_transform
from ipoke_tpu_torch.nn.core import weight_norm_materialize
from ipoke_tpu_torch.ops.cuda.mcf_inverse import mcf_inverse, mcf_inverse_plain


def default_hidden(in_channels):
    if in_channels <= 96:
        return 4 * in_channels
    return min(2 * in_channels, 512)


def forward(p, x, h=None, order="A", transform="affine", alpha=1.0, act="elu"):
    T = get_transform(transform)
    raw = convnets.mcf_block_apply(p["net"], x, order, h=h, act=act)
    return T.fwd(x, T.calc_params(raw, alpha))


def inverse(p, z, h=None, order="A", transform="affine", alpha=1.0, act="elu",
            backend="scan"):
    get_transform(transform)
    conv1x1 = p["net"]["conv1x1"]
    w1 = weight_norm_materialize(conv1x1["v"], conv1x1["g"])
    w1 = w1.reshape(w1.shape[0], -1)
    args = (z, h, p["net"]["shift_conv"]["w"], w1, conv1x1["b"], order, alpha, act)
    if backend == "scan":
        return mcf_inverse_plain(*args)
    if backend == "cuda":
        return mcf_inverse(*args)
    raise ValueError(f"mcf backend {backend!r} is not 'scan' or 'cuda'")
