"""Conv subnets of the flow blocks (counterpart of ``ipoke_tpu/flows/convnets.py``).

  wn conv        weight-normed conv (v, g, b)
  shifted conv   causal conv, orders A-D
  MCF block      shifted conv -> [cat h] -> act -> 1x1 wn conv
  NICE block     3x3 -> act -> 1x1 -> [cat h] -> act -> 3x3 wn conv
  attention NICE gated conv to hidden -> conv-attention block -> act
                 -> conv-attention block -> [cat h] -> act -> 3x3 wn conv
                 (``flows/attention``)

A NICE block whose convs are split over a tensor-parallel group (the rule
``parallel/sharding.flow_param_shardings``: conv1 by its output channels,
conv2 and conv3 by their input channels) runs split inside
``model_parallel(group)``; the attention block is not split.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.flows import attention as attn
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import activation, conv2d
from ipoke_tpu_torch.parallel import distributed
from ipoke_tpu_torch.utils import prng

_MODEL_GROUP = contextvars.ContextVar("ipoke_model_group", default=None)


def init_wn_conv(key, kh, kw, c_in, c_out, device="cpu", zero_init=True):
    """A fresh flow starts as the identity: ``g = 0`` zeroes the output conv;
    without ``zero_init``, ``g = ||v||`` per output channel (torch's
    weight_norm init)."""
    v = 0.05 * prng.normal(key, (kh, kw, c_in, c_out), device)
    g = torch.zeros(c_out, device=device) if zero_init else v.square().sum(dim=(0, 1, 2)).sqrt()
    return {"v": core.from_hwio(v), "g": g, "b": torch.zeros(c_out, device=device)}


def _torch_default_conv(key, shape, device):
    return {"w": core.from_hwio(core.kaiming_uniform_torch_default(key, shape, device))}


def init_shifted_conv(key, kernel_size, c_in, c_out, device="cpu"):
    return _torch_default_conv(key, tuple(kernel_size) + (c_in, c_out), device)


def init_mcf_block(key, c_in, c_out, kernel_size, hidden, h_channels=None, device="cpu"):
    k1, k2 = prng.split(key)
    return {"shift_conv": init_shifted_conv(k1, kernel_size, c_in, hidden, device),
            "conv1x1": init_wn_conv(k2, 1, 1, hidden + (h_channels or 0), c_out, device=device)}


def init_nice_conv_block(key, c_in, c_out, hidden, h_channels=0, attention=False, heads=4,
                         spatial_size=8, device="cpu"):
    """conv3 reads hidden + ``h_channels`` (``condition_nice``).  The
    attention block draws ``in_resnet`` and ``conv1`` both from the first
    subkey, as JAX does."""
    k1, k2, k3, k4 = prng.split(key, 4)
    conv3 = init_wn_conv(k3, 3, 3, hidden + h_channels, c_out, device=device)
    if attention:
        return {"in_resnet": attn.init_gated_conv(k1, c_in, dim_out=hidden, device=device),
                "pos_emb": prng.normal(k4, (spatial_size, spatial_size, hidden), device),
                "conv1": attn.init_conv_attn_block(k1, hidden, spatial_size, device),
                "conv2": attn.init_conv_attn_block(k2, hidden, spatial_size, device),
                "conv3": conv3}
    return {"conv1": _torch_default_conv(k1, (3, 3, c_in, hidden), device),
            "conv2": _torch_default_conv(k2, (1, 1, hidden, hidden), device),
            "conv3": conv3}


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


@contextlib.contextmanager
def model_parallel(group):
    """NICE blocks holding split convs run split over ``group`` (the
    ``model`` axis of the mesh) inside this context."""
    token = _MODEL_GROUP.set(group)
    try:
        yield
    finally:
        _MODEL_GROUP.reset(token)


def _nice_split(p, x, h, f, group):
    """The NICE block on this rank's shards: conv1's output channels, conv2's
    and conv3's input channels.  conv2's and conv3's partial sums are summed
    over ``group``; conv3's weight norm sums its squares over the shards.
    Input and output are the same on every rank of ``group``."""
    x = distributed.copy_to(x, group)
    out = f(conv2d(x, p["conv1"]["w"], None, padding=1))
    out = distributed.reduce_from(conv2d(out, p["conv2"]["w"], None, padding=0), group)
    if h is not None:
        out = torch.cat([out, h.to(out.dtype)], dim=-1)
    v, g, b = p["conv3"]["v"], p["conv3"]["g"], p["conv3"]["b"]
    k = v.shape[1]
    mine = distributed.copy_to(f(out), group).narrow(-1, distributed.group_rank(group) * k, k)
    sq = distributed.all_reduce(v.square().sum(dim=(1, 2, 3), keepdim=True), group)
    g = distributed.copy_to(g, group).reshape(-1, 1, 1, 1).to(v.dtype)
    w = v / sq.sqrt().clamp_min(1e-12) * g
    return distributed.reduce_from(conv2d(mine, w, None, padding=1), group) + b.to(out.dtype)


def nice_conv_block_apply(p, x, h=None, act="elu", heads=4):
    f = activation(act)
    if "in_resnet" in p:   # the attention block
        out = attn.gated_conv_apply(p["in_resnet"], x)
        out = f(attn.conv_attn_block_apply(p["conv1"], out, p["pos_emb"], heads))
        out = attn.conv_attn_block_apply(p["conv2"], out, p["pos_emb"], heads)
        if h is not None:
            out = torch.cat([out, h.to(out.dtype)], dim=-1)
        return wn_conv_apply(p["conv3"], f(out), padding=1)
    if p["conv1"]["w"].shape[0] != p["conv2"]["w"].shape[0]:   # conv1 split by its outputs
        group = _MODEL_GROUP.get()
        if group is None:
            raise RuntimeError("a NICE block of split convs outside model_parallel(group)")
        return _nice_split(p, x, h, f, group)
    out = f(conv2d(x, p["conv1"]["w"], None, padding=1))
    out = conv2d(out, p["conv2"]["w"], None, padding=0)
    if h is not None:
        out = torch.cat([out, h.to(out.dtype)], dim=-1)
    return wn_conv_apply(p["conv3"], f(out), padding=1)
