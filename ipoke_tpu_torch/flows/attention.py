"""Gated-conv and attention blocks of the flow subnets (counterpart of
``ipoke_tpu/flows/attention.py``), used by ``attention`` NICE couplings and
``cond_conv`` MaCowUnits.

ConcatELU doubles the channels as cat(elu(x), elu(-x)); the gate is
a * sigmoid(b) over a channel split.  The attention layer is multi-head
attention over the H x W grid with a learned positional embedding and a
gated residual; the layer norm normalises over (H, W, C) with an (H, W, C)
affine.  Convs are OIHW (``nn/core.from_hwio``); the projections are JAX's
``(in, out)`` matrices, ``pos_emb`` and the layer norm's affine (H, W, C).
Every ``init_*`` draws JAX's params from JAX's key.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import conv2d
from ipoke_tpu_torch.utils import prng


def concat_elu(x):
    return torch.cat([F.elu(x), F.elu(-x)], dim=-1)


def gate(x):
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)


def _conv(key, shape, device):
    return {"w": core.from_hwio(core.kaiming_uniform_torch_default(key, shape, device)),
            "b": torch.zeros(shape[-1], device=device)}


def init_gated_conv(key, dim, dim_out=None, dim_cond=None, device="cpu"):
    ks = prng.split(key, 4)
    dim_out = dim_out or dim
    p = {"conv1": _conv(ks[0], (3, 3, 2 * dim, dim), device),
         "conv2": _conv(ks[1], (3, 3, 2 * dim, 2 * dim_out), device)}
    if dim_out != dim:
        p["conv_sc"] = _conv(ks[2], (1, 1, dim, dim_out), device)
    if dim_cond is not None:
        p["cond_conv"] = _conv(ks[3], (3, 3, 2 * dim_cond, dim), device)
    return p


def gated_conv_apply(p, x, xc=None):
    c1 = conv2d(concat_elu(x), p["conv1"]["w"], p["conv1"]["b"], padding=1)
    if "conv_sc" in p:
        x = conv2d(x, p["conv_sc"]["w"], p["conv_sc"]["b"])
    if xc is not None and "cond_conv" in p:
        c1 = c1 + conv2d(concat_elu(xc), p["cond_conv"]["w"], p["cond_conv"]["b"], padding=1)
    c2 = conv2d(concat_elu(c1), p["conv2"]["w"], p["conv2"]["b"], padding=1)
    return x + gate(c2)


def init_attn_layer(key, channels, device="cpu"):
    k1, k2 = prng.split(key)
    return {"proj1": {"w": 0.05 * prng.normal(k1, (channels, 3 * channels), device),
                      "b": torch.zeros(3 * channels, device=device)},
            "proj2": {"w": 0.05 * prng.normal(k2, (channels, 2 * channels), device),
                      "b": torch.zeros(2 * channels, device=device)}}


def attn_layer_apply(p, x, pos_emb, heads):
    """x: (B,H,W,C); pos_emb: (H,W,C)."""
    b, h, w, c = x.shape
    d, t = c // heads, h * w
    qkv = (x + pos_emb[None]).reshape(b, t, c) @ p["proj1"]["w"] + p["proj1"]["b"]
    q, k, v = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d), dim=-1)
    out = (att @ v).permute(0, 2, 1, 3).reshape(b, t, c)
    gate_in = out @ p["proj2"]["w"] + p["proj2"]["b"]
    return x + gate(gate_in.reshape(b, h, w, 2 * c))


def layer_norm(x, gamma=None, beta=None, eps=1e-5):
    """torch's ``LayerNorm((C, H, W))`` on NCHW: normalised over (H, W, C)
    of NHWC, with an elementwise (H, W, C) affine."""
    var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma[None] + beta[None]
    return y


def init_conv_attn_block(key, channels, spatial_size=None, device="cpu"):
    k1, k2 = prng.split(key)
    p = {"gated": init_gated_conv(k1, channels, device=device),
         "attn": init_attn_layer(k2, channels, device)}
    if spatial_size is not None:
        shape = (spatial_size, spatial_size, channels)
        p["ln"] = {"gamma": torch.ones(shape, device=device),
                   "beta": torch.zeros(shape, device=device)}
    return p


def conv_attn_block_apply(p, x, pos_emb, heads):
    ln = p.get("ln")
    g, b = (ln["gamma"], ln["beta"]) if ln else (None, None)
    x = layer_norm(gated_conv_apply(p["gated"], x), g, b)
    return layer_norm(attn_layer_apply(p["attn"], x, pos_emb, heads), g, b)
