"""Plain NHWC layers shared by the reference's towers, flow, decoder and
discriminators.  Conv weights are OIHW / OIDHW, transpose-conv weights
``(in, out, kh, kw)``, as the port stores them.  Each res block runs its
convs one by one (the port stacks res_conv and conv1 into one conv)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, b=None, stride=1, padding=0):
    return nhwc(F.conv2d(nchw(x), w, b, stride=stride, padding=padding))


def conv_transpose2d(x, w, b=None, stride=2, padding=1, output_padding=1):
    return nhwc(F.conv_transpose2d(nchw(x), w, b, stride=stride, padding=padding,
                                   output_padding=output_padding))


def conv3d(x, w, stride=1, padding=0):
    return F.conv3d(x.movedim(-1, 1), w, stride=stride, padding=padding).movedim(1, -1)


def group_norm(x, gamma=None, beta=None, groups=16, eps=1e-5):
    y = F.group_norm(x.movedim(-1, 1), groups, eps=eps).movedim(1, -1)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def instance_norm(x, eps=1e-5):
    return nhwc(F.instance_norm(nchw(x), eps=eps))


ACT = {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh, "none": lambda x: x,
       "lrelu": lambda x: F.leaky_relu(x, 0.2)}


def weight_norm(v, g):
    """``g * v / ||v||``, the norm over every axis but the first."""
    norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return v / norm.clamp_min(1e-12) * g.reshape((-1,) + (1,) * (v.ndim - 1))


def spectral_normalize(w, u, out_axis=0, eps=1e-12):
    """One power iteration: ``(w / sigma, u_new)``; gradients flow through
    ``w`` and ``u``, the returned ``u`` is detached."""
    w_mat = w.movedim(out_axis, 0).reshape(w.shape[out_axis], -1)
    v = w_mat.T @ u
    v = v / (torch.linalg.vector_norm(v) + eps)
    u = w_mat @ v
    u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ (w_mat @ v)), u.detach()


def map_spectral(tree, fn):
    """``tree`` with ``fn(node)`` in place of each dict node that holds ``w`` and ``u``."""
    if isinstance(tree, dict):
        if "w" in tree and "u" in tree:
            return fn(tree)
        return {k: map_spectral(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_spectral(v, fn) for v in tree]
    return tree


def spectral_tree(tree, transposed=False):
    def fn(node):
        w, u = spectral_normalize(node["w"], node["u"], 1 if transposed else 0)
        return dict(node, w=w, u=u)
    return map_spectral(tree, fn)


def refresh_u(tree, transposed=False):
    def fn(node):
        with torch.no_grad():
            _, u = spectral_normalize(node["w"], node["u"], 1 if transposed else 0)
            node["u"].copy_(u)
        return node
    map_spectral(tree, fn)


def _norm(y, p, norm):
    if norm == "group":
        return group_norm(y, p["norm"]["gamma"], p["norm"]["beta"])
    if norm == "in":
        return instance_norm(y)
    return y


def conv_block(p, x, stride=1, padding=1, norm="none", act="elu"):
    y = conv2d(x, p["conv"]["w"], p["conv"].get("b"), stride=stride, padding=padding)
    return ACT[act](_norm(y, p, norm))


def convT_block(p, x, norm="none", act="elu"):
    """The reference's transpose block turns 'elu' into ReLU."""
    y = conv_transpose2d(x, p["conv"]["w"], p["conv"].get("b"))
    return ACT["relu" if act == "elu" else act](_norm(y, p, norm))


def res_block(p, x, norm="in", act="elu", upsampling=False, stride=1):
    residual = x
    if "res_conv" in p:
        residual = (convT_block(p["res_conv"], x, norm="in", act=act) if upsampling
                    else conv_block(p["res_conv"], x, stride=stride, norm="in", act=act))
    out = (convT_block(p["conv1"], x, norm=norm, act=act) if upsampling
           else conv_block(p["conv1"], x, stride=stride, norm=norm, act=act))
    return conv_block(p["conv2"], out, norm=norm, act="none") + residual


def resize_bilinear(x, size):
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return nhwc(F.interpolate(nchw(x), size=tuple(size), mode="bilinear", align_corners=True))
