"""Low-level NN primitives on NHWC tensors (counterpart of ``ipoke_tpu/nn/core.py``).

Conventions
-----------
* Activations are NHWC, as in the JAX package; each op views them as NCHW
  for ``torch.nn.functional`` and returns NHWC.
* Conv weights are torch's OIHW; transpose-conv weights are torch's
  ``(in, out, kh, kw)``.  ``ckpt/jax_bridge.py`` maps the JAX package's HWIO
  kernels onto these layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _cast(t, like):
    return None if t is None else t.to(like.dtype)


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1):
    """2D conv, NHWC x OIHW.  ``padding`` is a symmetric int or ((t,b),(l,r))."""
    if not isinstance(padding, int):
        (t, bo), (l, r) = padding
        x = _nhwc(F.pad(_nchw(x), (l, r, t, bo)))
        padding = 0
    y = F.conv2d(_nchw(x), w.to(x.dtype), _cast(b, x), stride=stride,
                 padding=padding, dilation=dilation)
    return _nhwc(y)


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=1):
    """torch ConvTranspose2d on NHWC; ``w`` is ``(in, out, kh, kw)``."""
    y = F.conv_transpose2d(_nchw(x), w.to(x.dtype), _cast(b, x), stride=stride,
                           padding=padding, output_padding=output_padding)
    return _nhwc(y)


def group_norm(x, gamma=None, beta=None, num_groups=16, eps=1e-5):
    """GroupNorm over NHWC with contiguous channel groups."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    y = _nhwc(F.group_norm(_nchw(x), num_groups, eps=eps))
    if gamma is not None:
        y = y * gamma.to(y.dtype)
    if beta is not None:
        y = y + beta.to(y.dtype)
    return y


def instance_norm(x, gamma=None, beta=None, eps=1e-5):
    """InstanceNorm2d (affine optional, torch default affine=False) on NHWC."""
    y = _nhwc(F.instance_norm(_nchw(x), eps=eps))
    if gamma is not None:
        y = y * gamma.to(y.dtype)
    if beta is not None:
        y = y + beta.to(y.dtype)
    return y


_ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "lrelu": lambda x: F.leaky_relu(x, 0.2),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
    None: lambda x: x,
}


def activation(name):
    return _ACTIVATIONS[name]


def resize_bilinear_align_corners(x, size):
    """F.interpolate(bilinear, align_corners=True) on NHWC."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(_nchw(x), size=tuple(size), mode="bilinear", align_corners=True)
    return _nhwc(y)


def weight_norm_materialize(v, g):
    """torch weight_norm: ``w = g * v / ||v||``, the norm over all dims but O.

    ``v``: OIHW, ``g``: (O,).
    """
    norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return v / norm.clamp_min(1e-12) * g.reshape((-1,) + (1,) * (v.ndim - 1)).to(v.dtype)
