"""3D-ResNet motion encoder (counterpart of ``ipoke_tpu/models/motion_encoder.py``).

Video layout (B, T, H, W, C); conv kernels OIDHW.  The encoder compresses a
T x S x S x 3 video into a (B, s, s, z_dim) motion latent, with the temporal
strides the reference derives from (max_frames, full_seq, spatial_size,
min_spatial_size).  ``apply``'s ``conv_fn``/``gn_fn``/``t_reduce`` hooks let
``parallel/seqpar.py`` run it on a time-sharded video.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import conv3d, group_norm
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class MotionEncoderSpec:
    channels: Tuple[int, ...]          # ENC_M_channels
    z_dim: int
    spatial_size: int                  # input H (= W)
    max_frames: int
    min_spatial_size: int = 8
    full_seq: bool = True
    deterministic: bool = False
    layers: Tuple[int, int, int, int] = (2, 2, 2, 2)  # resnet18

    def derived(self):
        """The reference's stride/layer plumbing:
        (channels, stride1, stride4, has_layer4, has_layer5, last_channels)."""
        channels = list(self.channels)
        first_block_down = (
            len(channels) - 1 < int(math.ceil(math.log2(self.max_frames))) or self.full_seq
        )
        stride1 = (2, 1, 1) if first_block_down else (1, 1, 1)
        stride4 = (2, 1, 1) if (self.full_seq and self.max_frames >= 16) else None
        if self.spatial_size // 2**3 > self.min_spatial_size:
            stride4 = (2, 2, 2)
        has_layer4 = stride4 is not None
        if has_layer4 and len(channels) < 5:
            channels.append(channels[-1])
        has_layer5 = self.spatial_size // 2**4 > self.min_spatial_size
        last_channels = channels[3]
        if has_layer4:
            last_channels = channels[4]
        if has_layer5:
            last_channels = channels[5]
        return channels, stride1, stride4, has_layer4, has_layer5, last_channels


def _gn(c, device):
    return {"gamma": torch.ones(c, device=device), "beta": torch.zeros(c, device=device)}


def _conv(key, shape, device):
    return {"w": core.from_hwio(core.kaiming_normal(key, shape, device=device))}


def _init_basic_block(key, c_in, c_out, stride, device):
    ks = prng.split(key, 3)
    p = {"conv1": _conv(ks[0], (3, 3, 3, c_in, c_out), device), "gn1": _gn(c_out, device),
         "conv2": _conv(ks[1], (3, 3, 3, c_out, c_out), device), "gn2": _gn(c_out, device)}
    if stride != (1, 1, 1) or c_in != c_out:
        p["down"] = dict(_conv(ks[2], (1, 1, 1, c_in, c_out), device), gn=_gn(c_out, device))
    return p


def _basic_block_apply(p, x, stride, conv_fn=conv3d, gn_fn=group_norm):
    out = conv_fn(x, p["conv1"]["w"], stride=stride, padding=1)
    out = F.relu(gn_fn(out, p["gn1"]["gamma"], p["gn1"]["beta"], 16))
    out = conv_fn(out, p["conv2"]["w"], stride=1, padding=1)
    out = gn_fn(out, p["gn2"]["gamma"], p["gn2"]["beta"], 16)
    residual = x
    if "down" in p:
        residual = conv_fn(x, p["down"]["w"], stride=stride, padding=0)
        residual = gn_fn(residual, p["down"]["gn"]["gamma"], p["down"]["gn"]["beta"], 16)
    return F.relu(out + residual)


def _init_layer(key, c_in, c_out, n_blocks, stride, device):
    blocks = [_init_basic_block(prng.fold_in(key, 0), c_in, c_out, stride, device)]
    for i in range(1, n_blocks):
        blocks.append(_init_basic_block(prng.fold_in(key, i), c_out, c_out, (1, 1, 1), device))
    return blocks


def _layer_apply(blocks, x, stride, conv_fn=conv3d, gn_fn=group_norm):
    x = _basic_block_apply(blocks[0], x, stride, conv_fn, gn_fn)
    for b in blocks[1:]:
        x = _basic_block_apply(b, x, (1, 1, 1), conv_fn, gn_fn)
    return x


def init(key, spec: MotionEncoderSpec, device="cpu"):
    channels, stride1, stride4, has_l4, has_l5, last_c = spec.derived()
    ks = prng.split(key, 8)

    def layer(i, stride):   # layer i (1..5) from key i; layer 5 repeats layer 4's depth
        return _init_layer(ks[i], channels[i - 1], channels[i], spec.layers[min(i, 4) - 1],
                           stride, device)

    p = {
        "conv1": _conv(ks[0], (3, 7, 7, 3, channels[0]), device),
        "gn1": _gn(channels[0], device),
        "layer1": layer(1, stride1),
        "layer2": layer(2, (2, 2, 2)),
        "layer3": layer(3, (2, 2, 2)),
    }
    for name, k in (("conv_mu", ks[6]), ("conv_var", ks[7])):
        w = core.kaiming_uniform_torch_default(k, (3, 3, last_c, spec.z_dim), device)
        p[name] = {"w": core.from_hwio(w), "b": torch.zeros(spec.z_dim, device=device)}
    if has_l4:
        p["layer4"] = layer(4, stride4)
    if has_l5:
        p["layer5"] = layer(5, (2, 2, 2))
    return p


def apply(params, x, spec: MotionEncoderSpec, rng=None, conv_fn=conv3d, gn_fn=group_norm,
          t_reduce=None):
    """x: (B, T, H, W, 3) video -> (z, mu, logvar), each (B, s, s, z_dim).

    Without a sampling key (the second stage) or with a deterministic spec,
    z is mu; with a JAX key ``rng`` (``utils/prng``), the reparameterised
    draw ``normal(rng, logvar.shape) * exp(logvar / 2) + mu``.

    ``conv_fn`` / ``gn_fn`` / ``t_reduce`` stand in for the 3D convs, the
    GroupNorms and the temporal squeeze, so that a caller can run
    communication-aware ops (``parallel/seqpar.py``: halo convs, GroupNorm
    of global moments, a cross-shard temporal mean) through the same layer
    plumbing; the defaults are the dense ops."""
    _, stride1, stride4, has_l4, has_l5, _ = spec.derived()
    out = conv_fn(x, params["conv1"]["w"], stride=(2, 2, 2), padding=(1, 3, 3))
    out = F.relu(gn_fn(out, params["gn1"]["gamma"], params["gn1"]["beta"], 16))
    out = _layer_apply(params["layer1"], out, stride1, conv_fn, gn_fn)
    out = _layer_apply(params["layer2"], out, (2, 2, 2), conv_fn, gn_fn)
    out = _layer_apply(params["layer3"], out, (2, 2, 2), conv_fn, gn_fn)
    if has_l4:
        out = _layer_apply(params["layer4"], out, stride4, conv_fn, gn_fn)
    if has_l5:
        out = _layer_apply(params["layer5"], out, (2, 2, 2), conv_fn, gn_fn)
    if t_reduce is not None:
        out = t_reduce(out)
    else:   # temporal squeeze
        out = out.squeeze(1) if out.shape[1] == 1 else out.mean(dim=1)
    mu = core.conv2d(out, params["conv_mu"]["w"], params["conv_mu"]["b"], padding=1)
    logvar = core.conv2d(out, params["conv_var"]["w"], params["conv_var"]["b"], padding=1)
    if spec.deterministic or rng is None:
        return mu, mu, logvar
    eps = prng.normal(rng, tuple(logvar.shape), logvar.device).to(mu.dtype)
    return eps * torch.exp(0.5 * logvar) + mu, mu, logvar
