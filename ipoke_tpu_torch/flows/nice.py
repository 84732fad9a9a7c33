"""NICE2d coupling for 2D data (counterpart of ``ipoke_tpu/flows/nice.py``).

Channel split (last axis, NHWC):
  continuous: [z1_channels | rest]
  skip:       even-index / odd-index channels (factor 2 only; an odd channel
              count falls back to continuous, as the reference does)
order 'up': z1 conditions the transform of z2; 'down': the other way round.
"""
from __future__ import annotations

import torch

from ipoke_tpu_torch.flows import convnets
from ipoke_tpu_torch.flows.transforms import get_transform


def nice_channels(in_channels, factor=2, split_type="continuous", order="up"):
    """Returns (split_type, z1_channels, net_in, net_out_base)."""
    if split_type == "skip":
        if factor != 2:
            raise ValueError("skip split needs factor 2")
        if in_channels % factor == 1:
            split_type = "continuous"
    out_channels = in_channels // factor
    net_in = in_channels - out_channels
    z1_channels = net_in if order == "up" else out_channels
    return split_type, z1_channels, net_in, out_channels


def _split(x, in_channels, factor, split_type, order):
    split_type, z1c, _, _ = nice_channels(in_channels, factor, split_type, order)
    if split_type == "continuous":
        return x[..., :z1c], x[..., z1c:]
    return x[..., 0::2], x[..., 1::2]


def _unsplit(z1, z2, in_channels, factor, split_type, order):
    split_type, _, _, _ = nice_channels(in_channels, factor, split_type, order)
    if split_type == "continuous":
        return torch.cat([z1, z2], dim=-1)
    # even channel count: z1 and z2 are the same size; interleave them
    return torch.stack([z1, z2], dim=-1).flatten(-2)


def _couple(p, x, h, in_channels, factor, split_type, order, transform, alpha, act, inverse):
    T = get_transform(transform)
    in_channels = in_channels or x.shape[-1]
    z1, z2 = _split(x, in_channels, factor, split_type, order)
    z, zp = (z1, z2) if order == "up" else (z2, z1)
    raw = convnets.nice_conv_block_apply(p["net"], z, h=h, act=act)
    params = T.calc_params(raw, alpha)
    zp, logdet = T.bwd(zp, params) if inverse else T.fwd(zp, params)
    z1, z2 = (z, zp) if order == "up" else (zp, z)
    return _unsplit(z1, z2, in_channels, factor, split_type, order), logdet


def forward(p, x, h=None, in_channels=None, factor=2, split_type="continuous",
            order="up", transform="affine", alpha=1.0, act="elu"):
    return _couple(p, x, h, in_channels, factor, split_type, order, transform,
                   alpha, act, inverse=False)


def inverse(p, y, h=None, in_channels=None, factor=2, split_type="continuous",
            order="up", transform="affine", alpha=1.0, act="elu"):
    return _couple(p, y, h, in_channels, factor, split_type, order, transform,
                   alpha, act, inverse=True)[0]
