"""GAN discriminators of first-stage training (counterpart of
``ipoke_tpu/models/discriminators.py``).

PatchDiscriminator: a 2D PatchGAN on single frames.  Temporal3DDiscriminator:
a 3D ResNet-18 on frame crops with GroupNorm and per-timestep FC heads.
Every conv carries a spectral-norm vector ``u``; a training step applies
``nn/blocks.materialize_spectral_norm`` to the tree before ``*_apply``.
Kernels are OIHW / OIDHW, activations NHWC / NDHWC.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.blocks import init_conv, spectral_u
from ipoke_tpu_torch.nn.core import conv2d, conv3d, group_norm, instance_norm
from ipoke_tpu_torch.utils import prng

# ---------------------------------------------------------------------------
# 2D PatchGAN
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PatchDiscSpec:
    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 3
    bce_loss: bool = False
    gp_weight: float = 0.0
    fmap_weight: float = 1.0
    gen_weight: float = 1.0


def init_patch_disc(key, spec: PatchDiscSpec, device="cpu"):
    ks = prng.split(key, spec.n_layers + 2)
    conv = lambda k, c_in, c_out: init_conv(k, 4, 4, c_in, c_out, snorm=True, device=device)  # noqa: E731
    mults = [min(2**n, 8) for n in range(spec.n_layers + 1)]
    return {
        "in_conv": conv(ks[0], spec.input_nc, spec.ndf),
        "layers": [conv(ks[n], spec.ndf * mults[n - 1], spec.ndf * mults[n])
                   for n in range(1, spec.n_layers + 1)],
        "out_conv": conv(ks[-1], spec.ndf * mults[-1], 1),
    }


def patch_disc_apply(p, x, spec: PatchDiscSpec):
    """x: (B,H,W,C) -> (pred (B,h,w,1), fmaps): InstanceNorm between layers,
    leaky ReLU 0.2; the last inner layer has stride 1."""
    x = F.leaky_relu(conv2d(x, p["in_conv"]["w"], p["in_conv"]["b"], stride=2, padding=1), 0.2)
    fmaps = []
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = conv2d(x, layer["w"], layer["b"], stride=2 if i < n - 1 else 1, padding=1)
        x = F.leaky_relu(instance_norm(x), 0.2)
        fmaps.append(x)
    pred = conv2d(x, p["out_conv"]["w"], p["out_conv"]["b"], stride=1, padding=1)
    return pred, fmaps


# ---------------------------------------------------------------------------
# 3D temporal discriminator (ResNet-18 layout)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TempDiscSpec:
    spatial_size: int = 128
    sequence_length: int = 12     # mf_dt
    num_classes: int = 1
    patch_temp: bool = False
    bce_loss: bool = False
    gp_weight: float = 1.0
    fmap_weight: float = 1.0
    gen_weight: float = 1.0
    layers: Tuple[int, int, int, int] = (2, 2, 2, 2)

    @property
    def stride_t(self):
        return 1 if self.patch_temp else 2


def _gn(c, device):
    return {"gamma": torch.ones(c, device=device), "beta": torch.zeros(c, device=device)}


def _conv3d_sn(key, c_in, c_out, device, k=3):
    """An orthogonal 3D kernel (JAX's DHWIO draw, stored OIDHW) with its
    ``u`` from ``fold_in(key, 7)``."""
    w = core.orthogonal(key, (k, k, k, c_in, c_out), device)
    return {"w": core.from_hwio(w), "u": spectral_u(key, c_out, device)}


def _init_block3d(key, c_in, c_out, stride, stride_t, device):
    ks = prng.split(key, 3)
    p = {"conv1": _conv3d_sn(ks[0], c_in, c_out, device), "gn1": _gn(c_out, device),
         "conv2": _conv3d_sn(ks[1], c_out, c_out, device), "gn2": _gn(c_out, device)}
    if stride != 1 or stride_t != 1 or c_in != c_out:
        p["down"] = _conv3d_sn(ks[2], c_in, c_out, device)
        p["down_gn"] = _gn(c_out, device)
    return p


def _block3d_apply(p, x, stride, stride_t):
    s = (stride_t, stride, stride)
    out = conv3d(x, p["conv1"]["w"], stride=s, padding=1)
    out = F.relu(group_norm(out, p["gn1"]["gamma"], p["gn1"]["beta"], 16))
    out = conv3d(out, p["conv2"]["w"], stride=1, padding=1)
    out = group_norm(out, p["gn2"]["gamma"], p["gn2"]["beta"], 16)
    residual = x
    if "down" in p:
        residual = conv3d(x, p["down"]["w"], stride=s, padding=1)
        residual = group_norm(residual, p["down_gn"]["gamma"], p["down_gn"]["beta"], 16)
    return F.relu(out + residual)


def init_temp_disc(key, spec: TempDiscSpec, device="cpu"):
    ks = prng.split(key, 8)
    st = spec.stride_t

    def layer(k, c_in, c_out, n, stride, stride_t):
        return [_init_block3d(prng.fold_in(k, i), c_in if i == 0 else c_out, c_out,
                              stride if i == 0 else 1, stride_t if i == 0 else 1, device)
                for i in range(n)]

    w1 = core.orthogonal(ks[0], (3, 7, 7, 3, 64), device)
    u1 = prng.normal(ks[6], (64,), device)   # conv1's u: ks[6], not fold_in(ks[0], 7)
    return {
        "conv1": {"w": core.from_hwio(w1), "u": u1 / (torch.linalg.vector_norm(u1) + 1e-12)},
        "gn1": _gn(64, device),
        "layer1": layer(ks[1], 64, 64, spec.layers[0], 1, 1),
        "layer2": layer(ks[2], 64, 128, spec.layers[1], 1, st),
        "layer3": layer(ks[3], 128, 256, spec.layers[2], 2, st),
        "layer4": layer(ks[4], 256, 512, spec.layers[3], 2, st),
        "fc": {"w": 0.02 * prng.normal(ks[5], (512, spec.num_classes), device)},
    }


def temp_disc_apply(p, x, spec: TempDiscSpec):
    """x: (B,T,H,W,3) -> (pred (B, T_last * num_classes), fmaps of the four layers)."""
    y = conv3d(x, p["conv1"]["w"], stride=(1, 2, 2), padding=(1, 3, 3))
    y = F.relu(group_norm(y, p["gn1"]["gamma"], p["gn1"]["beta"], 16))
    # max pool k3 s(1,2,2) p1; torch pads with -inf as JAX's reduce_window does
    y = F.max_pool3d(y.movedim(-1, 1), 3, stride=(1, 2, 2), padding=1).movedim(1, -1)
    fmaps = []
    st = spec.stride_t
    for name, stride, stride_t in (("layer1", 1, 1), ("layer2", 1, st), ("layer3", 2, st),
                                   ("layer4", 2, st)):
        blocks = p[name]
        y = _block3d_apply(blocks[0], y, stride, stride_t)
        for b in blocks[1:]:
            y = _block3d_apply(b, y, 1, 1)
        fmaps.append(y)
    y = y.mean(dim=(2, 3))   # (B, T', 512): average over the last feature map's H, W
    pred = torch.einsum("btc,cn->btn", y, p["fc"]["w"].to(y.dtype)).reshape(y.shape[0], -1)
    return pred, fmaps


# ---------------------------------------------------------------------------
# losses of both discriminators
# ---------------------------------------------------------------------------


def disc_loss(pred, real: bool, bce: bool = False):
    """Hinge loss, or binary cross-entropy on logits with ``bce``."""
    if bce:
        target = float(real)
        return torch.mean(pred.clamp_min(0) - pred * target + torch.log1p(torch.exp(-pred.abs())))
    return torch.mean(F.relu(1.0 - pred if real else 1.0 + pred))


def gen_loss(pred_fake, bce: bool = False):
    if bce:
        return disc_loss(pred_fake, real=True, bce=True)
    return -torch.mean(pred_fake)


def fmap_loss(fmaps_a, fmaps_b, kind="l1"):
    """Mean over the maps of each map's mean |a - b| (or squared difference)."""
    total = 0.0
    for a, b in zip(fmaps_a, fmaps_b):
        total = total + (torch.mean((a - b).abs()) if kind == "l1" else torch.mean((a - b) ** 2))
    return total / len(fmaps_a)


def gradient_penalty(pred, x):
    """R1-style penalty of a prediction ``pred`` made from ``x`` (which
    requires grad): the squared norm of ``d pred.sum() / dx`` summed per
    example, averaged over the batch, differentiable again."""
    (g,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
    return torch.mean(g.reshape(g.shape[0], -1).square().sum(dim=1))
