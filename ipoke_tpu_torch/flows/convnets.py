"""Conv subnets of the flow blocks (counterpart of ``ipoke_tpu/flows/convnets.py``).

  wn conv        weight-normed conv (v, g, b)
  shifted conv   causal conv, orders A-D
  MCF block      shifted conv -> [cat h] -> act -> 1x1 wn conv
  NICE block     3x3 -> act -> 1x1 -> [cat h] -> act -> 3x3 wn conv

The attention NICE block waits in ROADMAP queue 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import activation, conv2d


def wn_conv_apply(p, x, padding=0):
    return conv2d(x, core.weight_norm_materialize(p["v"], p["g"]), p["b"], padding=padding)


# Orders (weights OIHW):
#   'A': output row i sees input rows i-kH .. i-1      (scan top -> bottom)
#   'B': output row i sees input rows i+1 .. i+kH      (scan bottom -> top)
#   'C': output col j sees input cols j-kW .. j-1      (scan left -> right)
#   'D': output col j sees input cols j+1 .. j+kW      (scan right -> left)
# A/B kernels are (kH, kW_sym), C/D kernels (kH_sym, kW).

def shifted_conv_apply(p, x, order):
    """x: (B,H,W,C).  Causal pad + slice + VALID conv."""
    w = p["w"]
    kh, kw = w.shape[2], w.shape[3]
    xc = x.permute(0, 3, 1, 2)
    if order == "A":
        cw = (kw - 1) // 2
        xp = F.pad(xc, (cw, cw, kh, 0))[:, :, :-1]
    elif order == "B":
        cw = (kw - 1) // 2
        xp = F.pad(xc, (cw, cw, 0, kh))[:, :, 1:]
    elif order == "C":
        ch = (kh - 1) // 2
        xp = F.pad(xc, (kw, 0, ch, ch))[:, :, :, :-1]
    elif order == "D":
        ch = (kh - 1) // 2
        xp = F.pad(xc, (0, kw, ch, ch))[:, :, :, 1:]
    else:
        raise ValueError(order)
    return F.conv2d(xp, w.to(x.dtype)).permute(0, 2, 3, 1)


def mcf_block_apply(p, x, order, h=None, act="elu"):
    c = shifted_conv_apply(p["shift_conv"], x, order)
    if h is not None:
        c = torch.cat([c, h.to(c.dtype)], dim=-1)
    return wn_conv_apply(p["conv1x1"], activation(act)(c))


def nice_conv_block_apply(p, x, h=None, act="elu"):
    if "in_resnet" in p:
        raise NotImplementedError(
            "attention NICE blocks are not ported yet (ROADMAP.md queue 1)")
    f = activation(act)
    out = f(conv2d(x, p["conv1"]["w"], None, padding=1))
    out = conv2d(out, p["conv2"]["w"], None, padding=0)
    if h is not None:
        out = torch.cat([out, h.to(out.dtype)], dim=-1)
    return wn_conv_apply(p["conv3"], f(out), padding=1)
