"""Low-level NN primitives on NHWC tensors (counterpart of ``ipoke_tpu/nn/core.py``).

Conventions
-----------
* Activations are NHWC, as in the JAX package; each op views them as NCHW
  for ``torch.nn.functional`` and returns NHWC.
* Conv weights are torch's OIHW (OIDHW in 3D); transpose-conv weights are
  torch's ``(in, out, kh, kw)``.  ``ckpt/jax_bridge.py`` maps the JAX
  package's HWIO kernels onto these layouts.
* The initialisers draw JAX's numbers from JAX's key (``utils/prng``) in the
  JAX layout (HWIO / DHWIO); :func:`from_hwio` moves a kernel to the port's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.utils import prng


class Policy:
    """Mixed precision: params in f32, compute in ``compute_dtype``."""

    def __init__(self, compute_dtype=torch.float32):
        self.compute_dtype = compute_dtype

    def cast(self, tree):
        """Every floating-point tensor of ``tree`` in ``compute_dtype``."""
        if isinstance(tree, dict):
            return {k: self.cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast(v) for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.compute_dtype)
        return tree


# ---------------------------------------------------------------------------
# initializers: JAX's draws, in JAX's layout
# ---------------------------------------------------------------------------

def _fan_in_out_conv(shape):
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def kaiming_normal(key, shape, device="cpu"):
    """kaiming_normal in fan_out mode."""
    _, fan_out = _fan_in_out_conv(shape)
    return math.sqrt(2.0 / fan_out) * prng.normal(key, shape, device)


def kaiming_uniform_torch_default(key, shape, device="cpu"):
    """torch's default conv init, kaiming_uniform(a=sqrt(5))."""
    fan_in, _ = _fan_in_out_conv(shape)
    bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    return prng.uniform(key, shape, -bound, bound, device)


def conv_bias_torch_default(key, shape_w, n_out, device="cpu"):
    fan_in, _ = _fan_in_out_conv(shape_w)
    bound = 1.0 / math.sqrt(fan_in)
    return prng.uniform(key, (n_out,), -bound, bound, device)


def orthogonal(key, shape, device="cpu"):
    """Orthogonal init over a conv kernel (all-but-last dims x last dim):
    QR of JAX's normal draw with its sign fix ``q * sign(diag r)``."""
    n_rows, n_cols = shape[-1], math.prod(shape[:-1])
    a = prng.normal(key, (max(n_rows, n_cols), min(n_rows, n_cols)), device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape((n_rows,) + tuple(shape[:-1])).permute(
        tuple(range(1, len(shape))) + (0,))


def _reverse3(w, a, b, c):
    """``w`` viewed as (a, b, c), returned as a contiguous (c, b, a): two
    2-D transposes, which copy in cache-sized blocks (a 3-D permute of a
    large kernel reads with a stride on the CPU, ~4x slower)."""
    return w.reshape(a, b * c).t().contiguous().view(b, c, a).transpose(0, 1).contiguous()


def from_hwio(w, transposed=False):
    """A JAX kernel (HWIO, DHWIO) in the port's layout: OIHW / OIDHW, or
    ``(in, out, kh, kw)`` for a transpose conv."""
    *k, i, o = w.shape
    n = math.prod(k)
    if transposed:   # (K, I*O) -> (I*O, K)
        return w.reshape(n, i * o).t().contiguous().view(i, o, *k)
    return _reverse3(w, n, i, o).view(o, i, *k)


def to_hwio(w, transposed=False):
    """The inverse of :func:`from_hwio`."""
    if transposed:
        i, o, *k = w.shape
        return w.reshape(i * o, math.prod(k)).t().contiguous().view(*k, i, o)
    o, i, *k = w.shape
    return _reverse3(w, o, i, math.prod(k)).view(*k, i, o)


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


def conv3d(x, w, stride=1, padding=0):
    """3D conv without bias, NDHWC x OIDHW; ``stride``/``padding`` an int or 3 ints."""
    y = F.conv3d(x.movedim(-1, 1), w.to(x.dtype), stride=stride, padding=padding)
    return y.movedim(1, -1)


def group_norm(x, gamma=None, beta=None, num_groups=16, eps=1e-5):
    """GroupNorm over NHWC or NDHWC with contiguous channel groups."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    y = F.group_norm(x.movedim(-1, 1), num_groups, eps=eps).movedim(1, -1)
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


def spectral_normalize(w, u, out_axis=0, eps=1e-12):
    """One power iteration of spectral norm: ``(w / sigma, u_new)``.

    ``w`` flattens to ``(O, rest)`` along ``out_axis``: 0 for OIHW / OIDHW,
    1 for a transpose conv's ``(in, out, kh, kw)``; ``u``: (O,).  Gradients
    flow through ``u`` and ``v`` as well as ``w`` (only the returned ``u``
    is detached), as in the JAX package; ``torch.nn.utils.spectral_norm``
    iterates under ``no_grad`` and so gives other gradients.
    """
    w_mat = w.movedim(out_axis, 0).reshape(w.shape[out_axis], -1)
    v = w_mat.T @ u
    v = v / (torch.linalg.vector_norm(v) + eps)
    u = w_mat @ v
    u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (w_mat @ v)
    return w / sigma, u.detach()



def space_to_depth(x, factor=2):
    """(B,H,W,C) -> (B,H/f,W/f,C*f*f) with the channels c-slowest, then the
    row and the column offset in the block: torch's ``pixel_unshuffle``
    order on NCHW, as the JAX package's ``space_to_depth``."""
    return _nhwc(F.pixel_unshuffle(_nchw(x), factor))


def depth_to_space(x, factor=2):
    """The inverse of :func:`space_to_depth` (torch's ``pixel_shuffle``)."""
    return _nhwc(F.pixel_shuffle(_nchw(x), factor))
