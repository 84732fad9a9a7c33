"""The 3D-conv SPADE + ADAIN video generator (counterpart of
``ipoke_tpu/models/motion_generator.py``): the reference's decoder before the
GRU one; the released first stage decodes frame by frame (``models/decoder``).

Layout NDHWC, 3D kernels OIDHW.  A block: SPADE(start frame) -> lrelu ->
conv3d -> ADAIN(motion) -> lrelu -> conv3d, plus a shortcut (Norm3D and a
1x1x1 conv where the widths differ).  As in the JAX package, the 2D SPADE
modulation is broadcast over time explicitly (the reference broadcasts it
only when C == T).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.blocks import spade_num_groups
from ipoke_tpu_torch.nn.core import conv2d, group_norm, resize_bilinear_align_corners
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class GeneratorSpec:
    img_size: int
    z_dim: int
    decoder_factor: int = 4
    spectral_norm: bool = True

    @property
    def nf(self):
        return self.decoder_factor


def _kernel(key, shape, device):
    return core.from_hwio(core.kaiming_uniform_torch_default(key, shape, device))


def _conv3d_p(key, k, ci, co, bias=True, device="cpu"):
    p = {"w": _kernel(key, (k, k, k, ci, co), device)}
    if bias:
        p["b"] = torch.zeros(co, device=device)
    return p


def _conv3d(x, p, padding):
    y = core.conv3d(x, p["w"], padding=padding)
    return y + p["b"].to(y.dtype) if "b" in p else y


def _spade3d_init(key, num_features, device):
    k1, k2, k3 = prng.split(key, 3)
    z = lambda n: torch.zeros(n, device=device)  # noqa: E731
    return {"conv": {"w": _kernel(k1, (3, 3, 3, 128), device), "b": z(128)},
            "conv_gamma": {"w": _kernel(k2, (3, 3, 128, num_features), device),
                           "b": z(num_features)},
            "conv_beta": {"w": _kernel(k3, (3, 3, 128, num_features), device),
                          "b": z(num_features)}}


def _spade3d_apply(p, x, frame):
    """x: (B,T,H,W,C); frame: (B,Hf,Wf,3).  GroupNorm without affine, the
    start frame's SPADE modulation broadcast over T."""
    normalized = group_norm(x, num_groups=spade_num_groups(x.shape[-1]))
    y = resize_bilinear_align_corners(frame, x.shape[2:4])
    y = F.leaky_relu(conv2d(y, p["conv"]["w"], p["conv"]["b"], padding=1), 0.2)
    gamma = conv2d(y, p["conv_gamma"]["w"], p["conv_gamma"]["b"], padding=1)[:, None]
    beta = conv2d(y, p["conv_beta"]["w"], p["conv_beta"]["b"], padding=1)[:, None]
    return normalized * (1.0 + gamma) + beta


def _adain3d_init(key, z_dim, num_features, device):
    return {"w": core.kaiming_uniform_torch_default(key, (z_dim, 2 * num_features), device),
            "b": torch.zeros(2 * num_features, device=device)}


def _adain3d_apply(p, x, z):
    """Instance norm per sample and channel over (T, H, W), then a linear
    map of z to gamma and beta."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = x.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    normalized = (x - mean) / torch.sqrt(var + 1e-5)
    gamma, beta = (z @ p["w"] + p["b"]).chunk(2, dim=-1)
    return (1.0 + gamma[:, None, None, None]) * normalized + beta[:, None, None, None]


def _block_init(key, n_in, n_out, z_dim, device):
    n_mid = min(n_in, n_out)
    ks = prng.split(key, 6)
    p = {"spade": _spade3d_init(ks[0], n_in, device),
         "conv0": _conv3d_p(ks[1], 3, n_in, n_mid, device=device),
         "adain": _adain3d_init(ks[2], z_dim, n_mid, device),
         "conv1": _conv3d_p(ks[3], 3, n_mid, n_out, device=device)}
    if n_in != n_out:
        p["conv_s"] = _conv3d_p(ks[4], 1, n_in, n_out, bias=False, device=device)
        p["norm_s"] = {"gamma": torch.ones(n_in, device=device),
                       "beta": torch.zeros(n_in, device=device)}
    return p


def _block_apply(p, x, motion, frame):
    lrelu = lambda a: F.leaky_relu(a, 0.2)  # noqa: E731
    if "conv_s" in p:
        ns = p["norm_s"]
        x_s = _conv3d(group_norm(x, ns["gamma"], ns["beta"], spade_num_groups(x.shape[-1])),
                      p["conv_s"], 0)
    else:
        x_s = x
    dx = _conv3d(lrelu(_spade3d_apply(p["spade"], x, frame)), p["conv0"], 1)
    dx = _conv3d(lrelu(_adain3d_apply(p["adain"], dx, motion)), p["conv1"], 1)
    return x_s + dx


def _upsample(x, factors: Tuple[int, int, int]):
    """Nearest-neighbour upsampling of (B,T,H,W,C) by (ft, fh, fw)."""
    for axis, f in zip((1, 2, 3), factors):
        if f > 1:
            x = x.repeat_interleave(f, dim=axis)
    return x


BLOCKS = ("head_0", "g_0", "g_1", "g_2", "g_3", "g_4")


def init(key, spec: GeneratorSpec, device="cpu"):
    nf = spec.nf
    ks = prng.split(key, 9)
    widths = (16 * nf, 16 * nf, 16 * nf, 8 * nf, 4 * nf, 2 * nf, nf)
    p = {"fc": {"w": core.kaiming_uniform_torch_default(ks[0], (spec.z_dim, 4 * 4 * 16 * nf),
                                                         device),
                "b": torch.zeros(4 * 4 * 16 * nf, device=device)}}
    for i, name in enumerate(BLOCKS):
        p[name] = _block_init(ks[1 + i], widths[i], widths[i + 1], spec.z_dim, device)
    p["conv_img"] = _conv3d_p(ks[7], 3, nf, 3, device=device)
    return p


def apply(params, img, motion, spec: GeneratorSpec):
    """img: (B,H,W,3) start frame; motion: (B,z).  Returns the video
    (B,T,H',W',3) in [-1, 1] (T grows 1 -> 2 at the (2,2,2) upsampling)."""
    b, nf = img.shape[0], spec.nf
    x = (motion @ params["fc"]["w"] + params["fc"]["b"]).reshape(b, 1, 4, 4, 16 * nf)
    x = _block_apply(params["head_0"], x, motion, img)
    for name, factors in (("g_0", (1, 2, 2)), ("g_1", (1, 2, 2)), ("g_2", (1, 2, 2)),
                          ("g_3", (2, 2, 2))):
        x = _block_apply(params[name], _upsample(x, factors), motion, img)
    if spec.img_size > 64:
        x = _upsample(x, (1, 2, 2))
    x = _block_apply(params["g_4"], x, motion, img)
    return torch.tanh(_conv3d(F.leaky_relu(x, 0.2), params["conv_img"], 1))
