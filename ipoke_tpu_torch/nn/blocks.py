"""Conv blocks on NHWC tensors (counterpart of ``ipoke_tpu/nn/blocks.py``).

Spectral-norm power-iteration vectors ``u`` play no part at inference (the
JAX package applies ``w`` as stored), so the port neither carries nor uses
them.
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
