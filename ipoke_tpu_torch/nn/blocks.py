"""Conv blocks on NHWC tensors (counterpart of ``ipoke_tpu/nn/blocks.py``).

Spectral norm: a conv whose reference counterpart is wrapped in
``torch.nn.utils.spectral_norm`` carries a power-iteration vector ``u`` beside
its kernel when it is drawn with ``snorm=True`` (training).  ``apply`` uses
``w`` as stored, as at inference; a training step applies
:func:`materialize_spectral_norm` to the tree first.  Sampling trees carry no
``u``: its draw (``fold_in(key, 7)``) consumes no split, so every other draw
is the same with or without it.  ``transposed=True`` gives a kernel for
``conv_transpose2d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import (
    activation,
    conv2d,
    conv_transpose2d,
    group_norm,
    instance_norm,
    resize_bilinear_align_corners,
)
from ipoke_tpu_torch.utils import prng


def spectral_u(key, c_out, device="cpu"):
    """The unit power-iteration vector of a spectral-normed conv drawn from ``key``."""
    u = prng.normal(prng.fold_in(key, 7), (c_out,), device)
    return u / (torch.linalg.vector_norm(u) + 1e-12)


def init_conv(key, kh, kw, c_in, c_out, transposed=False, snorm=False, device="cpu"):
    """torch's default conv init (the JAX package's ``init='torch'``)."""
    kw_, kb = prng.split(key)
    shape = (kh, kw, c_in, c_out)
    p = {"w": core.from_hwio(core.kaiming_uniform_torch_default(kw_, shape, device), transposed),
         "b": core.conv_bias_torch_default(kb, shape, c_out, device)}
    if snorm:
        p["u"] = spectral_u(key, c_out, device)
    return p


def init_conv2d_block(key, c_in, c_out, ks, norm="none", transposed=False, snorm=False,
                      device="cpu"):
    k1, _ = prng.split(key)
    p = {"conv": init_conv(k1, ks, ks, c_in, c_out, transposed=transposed, snorm=snorm,
                           device=device)}
    if norm == "group":
        p["norm"] = {"gamma": torch.ones(c_out, device=device),
                     "beta": torch.zeros(c_out, device=device)}
    return p


def init_convT2d_block(key, c_in, c_out, ks, norm="none", snorm=False, device="cpu"):
    """The kernel of ``convT2d_block_apply``: ``(in, out, kh, kw)``."""
    return init_conv2d_block(key, c_in, c_out, ks, norm, transposed=True, snorm=snorm,
                             device=device)


def init_res_block(key, c_in, c_out, norm="in", upsampling=False, stride=1, snorm=False,
                   device="cpu"):
    k1, k2, k3 = prng.split(key, 3)
    first = init_convT2d_block if upsampling else init_conv2d_block   # conv1 and res_conv
    p = {"conv1": first(k1, c_in, c_out, 3, norm, snorm=snorm, device=device),
         "conv2": init_conv2d_block(k2, c_out, c_out, 3, norm, snorm=snorm, device=device)}
    if c_in != c_out or upsampling or stride != 1:
        p["res_conv"] = first(k3, c_in, c_out, 3, "none", snorm=snorm, device=device)
    return p


def _map_spectral(params, fn):
    """``params`` with ``fn(node)`` in place of every dict node holding ``w`` and ``u``."""
    if isinstance(params, dict):
        if "w" in params and "u" in params:
            return fn(params)
        return {k: _map_spectral(v, fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_map_spectral(v, fn) for v in params)
    return params


def materialize_spectral_norm(params, transposed=False):
    """Every ``w`` that carries a ``u`` replaced by ``w / sigma`` after one
    power iteration, with the new ``u`` beside it (detached); gradients flow
    to ``w`` and ``u``.  ``transposed``: the kernels of ``params`` are
    transpose convs ``(in, out, kh, kw)``, normalised along axis 1."""
    def fn(node):
        w, u = core.spectral_normalize(node["w"], node["u"], out_axis=1 if transposed else 0)
        return dict(node, w=w, u=u)

    return _map_spectral(params, fn)


def refresh_spectral_u(params, transposed=False):
    """One power iteration of each stored ``u``, in place and without
    gradient; the weights stay as they are (a training step runs it after
    the optimizer update, as torch refreshes its buffer every forward)."""
    def fn(node):
        with torch.no_grad():
            _, u = core.spectral_normalize(node["w"], node["u"], out_axis=1 if transposed else 0)
            node["u"].copy_(u)
        return node

    _map_spectral(params, fn)


def init_norm_conv2d(key, ks, c_in, c_out, device="cpu"):
    k1, _ = prng.split(key)
    shape = (ks, ks, c_in, c_out)
    v = core.kaiming_uniform_torch_default(k1, shape, device)
    return {
        "v": core.from_hwio(v),
        "g": v.square().sum(dim=(0, 1, 2)).sqrt(),   # torch weight_norm init: g = ||v||
        "b": core.conv_bias_torch_default(prng.fold_in(key, 3), shape, c_out, device),
        "gamma": torch.ones((1, 1, 1, c_out), device=device),
        "beta": torch.zeros((1, 1, 1, c_out), device=device),
    }


def init_spade(key, num_features, device="cpu"):
    k1, k2, k3 = prng.split(key, 3)
    return {"conv": init_conv(k1, 3, 3, 3, 128, device=device),
            "conv_gamma": init_conv(k2, 3, 3, 128, num_features, device=device),
            "conv_beta": init_conv(k3, 3, 3, 128, num_features, device=device)}


def _norm(y, p, norm):
    if norm == "group":
        return group_norm(y, p["norm"]["gamma"], p["norm"]["beta"], num_groups=16)
    if norm == "in":
        return instance_norm(y)
    return y


def conv2d_block_apply(p, x, stride=1, padding=0, norm="none", act="elu"):
    y = conv2d(x, p["conv"]["w"], p["conv"].get("b"), stride=stride, padding=padding)
    return activation(act)(_norm(y, p, norm))


def convT2d_block_apply(p, x, stride=2, padding=1, norm="none", act="elu"):
    """Reference quirk kept from the JAX package: activation 'elu' becomes ReLU."""
    if act == "elu":
        act = "relu"
    y = conv_transpose2d(x, p["conv"]["w"], p["conv"].get("b"), stride=stride,
                         padding=padding, output_padding=padding)
    return activation(act)(_norm(y, p, norm))


def _fusable(p, upsampling):
    """res_conv and conv1 read the same input with the same kernel geometry."""
    if "res_conv" not in p:
        return False
    rc, c1 = p["res_conv"]["conv"], p["conv1"]["conv"]
    rw, cw = rc["w"].shape, c1["w"].shape
    # in-channels and kernel extent: OIHW dims 1..3, (in,out,kh,kw) dims 0,2,3
    geo = (lambda s: (s[0], s[2], s[3])) if upsampling else (lambda s: tuple(s[1:]))
    return geo(rw) == geo(cw) and (rc.get("b") is None) == (c1.get("b") is None)


def res_block_apply(p, x, norm="in", act="elu", upsampling=False, stride=1):
    residual = x
    if _fusable(p, upsampling):
        # One conv with both kernels stacked on the output axis (OIHW dim 0,
        # transpose-conv dim 1) computes res_conv and conv1 at once; each
        # output channel's sum is the same as in the separate convs.
        rc, c1 = p["res_conv"]["conv"], p["conv1"]["conv"]
        out_dim = 1 if upsampling else 0
        n_res = rc["w"].shape[out_dim]
        w = torch.cat([rc["w"], c1["w"]], dim=out_dim)
        b = torch.cat([rc["b"], c1["b"]]) if rc.get("b") is not None else None
        if upsampling:
            y = conv_transpose2d(x, w, b, stride=2, padding=1, output_padding=1)
        else:
            y = conv2d(x, w, b, stride=stride, padding=1)
        r, o = y[..., :n_res], y[..., n_res:]
        a = ("relu" if act == "elu" else act) if upsampling else act
        residual = activation(a)(instance_norm(r))
        out = activation(a)(_norm(o, p["conv1"], norm))
    else:
        if "res_conv" in p:
            if upsampling:
                residual = convT2d_block_apply(p["res_conv"], x, stride=2, padding=1, norm="in", act=act)
            else:
                residual = conv2d_block_apply(p["res_conv"], x, stride=stride, padding=1, norm="in", act=act)
        if upsampling:
            out = convT2d_block_apply(p["conv1"], x, stride=2, padding=1, norm=norm, act=act)
        else:
            out = conv2d_block_apply(p["conv1"], x, stride=stride, padding=1, norm=norm, act=act)
    out = conv2d_block_apply(p["conv2"], out, stride=1, padding=1, norm=norm, act="none")
    return out + residual


def norm_conv2d_apply(p, x, stride=1, padding=0):
    """Weight-normed conv with per-channel gamma/beta, each (1,1,1,C)."""
    w = core.weight_norm_materialize(p["v"], p["g"])
    y = conv2d(x, w, p["b"], stride=stride, padding=padding)
    return p["gamma"].to(y.dtype) * y + p["beta"].to(y.dtype)


# ---------------------------------------------------------------------------
# SPADE: group-normalise x (no affine), modulate with gamma/beta computed from
# the bilinearly resized start frame.
# ---------------------------------------------------------------------------

def spade_num_groups(num_features, num_groups=16):
    while num_features % num_groups != 0:
        num_groups -= 1
    return num_groups


def spade_shared_feat(p, y_frame, hw):
    y = resize_bilinear_align_corners(y_frame, hw)
    return F.leaky_relu(conv2d(y, p["conv"]["w"], p["conv"]["b"], padding=1), 0.2)


def spade_modulation(p, y_frame, hw):
    """The per-stage SPADE modulation {'gamma','beta'} of a start frame."""
    y = spade_shared_feat(p, y_frame, hw)
    return {
        "gamma": conv2d(y, p["conv_gamma"]["w"], p["conv_gamma"]["b"], padding=1),
        "beta": conv2d(y, p["conv_beta"]["w"], p["conv_beta"]["b"], padding=1),
    }


def spade_apply(p, x, y_frame, shared_mod=None):
    """x: (B,H,W,C); y_frame: (B,Hf,Wf,3).  ``shared_mod`` skips the SPADE
    convs with a modulation precomputed by :func:`spade_modulation`."""
    normalized = group_norm(x, None, None, num_groups=spade_num_groups(x.shape[-1]))
    mod = shared_mod if shared_mod is not None else spade_modulation(p, y_frame, x.shape[1:3])
    return normalized * (1.0 + mod["gamma"]) + mod["beta"]
