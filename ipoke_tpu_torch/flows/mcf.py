"""Masked Convolutional Flow (counterpart of ``ipoke_tpu/flows/mcf.py``).

The forward (density) direction is one shifted-conv pass.  The inverse is a
recurrence along one spatial axis; all four orders reduce to the canonical
row scan of order A by flips and transposes (``_canonicalize``).  Backends:

  'scan'  the plain PyTorch row loop (``ops/cuda/mcf_inverse.mcf_inverse_plain``),
          the counterpart of the JAX ``_row_scan_inverse``;
  'cuda'  kernel K1 for each MCF (the counterpart of JAX ``'pallas'``).

The JAX scan hoists the conditioning half of the 1x1 conv out of the loop;
the port's loop keeps the concatenated form of the kernel.  Both are the same
sum, grouped differently (~1 ulp).
"""
from __future__ import annotations

from ipoke_tpu_torch.flows import convnets
from ipoke_tpu_torch.flows.transforms import get_transform
from ipoke_tpu_torch.nn.core import weight_norm_materialize
from ipoke_tpu_torch.ops.cuda.mcf_inverse import canonical, mcf_inverse, mcf_inverse_plain


def default_hidden(in_channels):
    if in_channels <= 96:
        return 4 * in_channels
    return min(2 * in_channels, 512)


def forward(p, x, h=None, order="A", transform="affine", alpha=1.0, act="elu"):
    T = get_transform(transform)
    raw = convnets.mcf_block_apply(p["net"], x, order, h=h, act=act)
    return T.fwd(x, T.calc_params(raw, alpha))


def _canonicalize(p, z, h, order):
    """(w, z, h, undo) with the problem mapped to canonical order A."""
    return canonical(p["net"]["shift_conv"]["w"], z, h, order)


def inverse(p, z, h=None, order="A", transform="affine", alpha=1.0, act="elu",
            backend="scan"):
    get_transform(transform)
    w_c, z_c, h_c, undo = _canonicalize(p, z, h, order)
    conv1x1 = p["net"]["conv1x1"]
    w1 = weight_norm_materialize(conv1x1["v"], conv1x1["g"])
    w1 = w1.reshape(w1.shape[0], -1)
    if backend == "scan":
        out = mcf_inverse_plain(z_c, h_c, w_c, w1, conv1x1["b"], alpha, act)
    elif backend == "cuda":
        out = mcf_inverse(z_c.contiguous(), None if h_c is None else h_c.contiguous(),
                          w_c.contiguous(), w1, conv1x1["b"], alpha, act)
    else:
        raise ValueError(f"mcf backend {backend!r} is not 'scan' or 'cuda'")
    return undo(out)
