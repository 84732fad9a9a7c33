"""The BigGAN decoder stack (counterpart of ``ipoke_tpu/models/biggan.py``),
which the reference defines and never imports.  Inference layout: spectral
norm folded into the weights, conditional batch norm on stored running
statistics.  Conv kernels OIHW; linear layers keep JAX's ``(in, out)``.

Generator64/128: the latent splits into ``num_split`` chunks; chunk 0 seeds
the 4x4 trunk, each further chunk conditions one GBlock through
cat([chunk, class embedding]); self-attention before block ``sa_id``; then
BN, relu, the colorize conv and tanh.  ``variable_dim`` splits as
(d - (k-1)*10, 10, ..., 10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import conv2d
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class BigGANSpec:
    resolution: int = 64           # 64 | 128
    code_dim: int = 120
    n_class: int = 1000
    chn: int = 96
    n_channels: int = 3

    @property
    def blocks(self) -> Tuple[Tuple[int, int], ...]:
        """(c_in, c_out) of each GBlock as multiples of ``chn``."""
        if self.resolution == 64:
            return ((16, 16), (16, 8), (8, 4), (4, 1))
        return ((16, 16), (16, 8), (8, 4), (4, 2), (2, 1))

    @property
    def sa_id(self):
        return 4 if self.resolution == 64 else 3

    @property
    def num_split(self):
        return len(self.blocks) + 1

    @property
    def z_per_chunk(self):
        return 20


def _linear(key, ci, co, bias=True, device="cpu"):
    p = {"w": core.kaiming_uniform_torch_default(key, (ci, co), device)}
    if bias:
        p["b"] = torch.zeros(co, device=device)
    return p


def _conv(key, k, ci, co, bias=True, device="cpu"):
    p = {"w": core.from_hwio(core.kaiming_uniform_torch_default(key, (k, k, ci, co), device))}
    if bias:
        p["b"] = torch.zeros(co, device=device)
    return p


def _cbn_init(key, num_features, z_dim, device):
    k1, k2 = prng.split(key)
    return {"gamma_embed": _linear(k1, z_dim, num_features, bias=False, device=device),
            "beta_embed": _linear(k2, z_dim, num_features, bias=False, device=device),
            "running_mean": torch.zeros(num_features, device=device),
            "running_var": torch.ones(num_features, device=device)}


def _cbn_apply(p, x, y):
    out = (x - p["running_mean"]) / torch.sqrt(p["running_var"] + 1e-4)
    gamma = y @ p["gamma_embed"]["w"] + 1.0
    beta = y @ p["beta_embed"]["w"]
    return gamma[:, None, None, :] * out + beta[:, None, None, :]


def _gblock_init(key, ci, co, z_dim, device):
    ks = prng.split(key, 5)
    return {"HyperBN": _cbn_init(ks[0], ci, z_dim, device),
            "conv0": _conv(ks[1], 3, ci, co, device=device),
            "HyperBN_1": _cbn_init(ks[2], co, z_dim, device),
            "conv1": _conv(ks[3], 3, co, co, device=device),
            "conv_sc": _conv(ks[4], 1, ci, co, device=device)}


def _up2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _gblock_apply(p, x, cond):
    out = F.relu(_cbn_apply(p["HyperBN"], x, cond))
    out = conv2d(_up2(out), p["conv0"]["w"], p["conv0"]["b"], padding=1)
    out = F.relu(_cbn_apply(p["HyperBN_1"], out, cond))
    out = conv2d(out, p["conv1"]["w"], p["conv1"]["b"], padding=1)
    return out + conv2d(_up2(x), p["conv_sc"]["w"], p["conv_sc"]["b"])


def _attn_init(key, c, device):
    ks = prng.split(key, 4)
    conv = lambda k, ci, co: _conv(k, 1, ci, co, bias=False, device=device)  # noqa: E731
    return {"theta": conv(ks[0], c, c // 8), "phi": conv(ks[1], c, c // 8),
            "g": conv(ks[2], c, c // 2), "o_conv": conv(ks[3], c // 2, c),
            "gamma": torch.zeros(1, device=device)}


def _pool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _attn_apply(p, x):
    b, h, w, _ = x.shape
    n = h * w
    theta = conv2d(x, p["theta"]["w"]).reshape(b, n, -1)
    phi = _pool2(conv2d(x, p["phi"]["w"])).reshape(b, n // 4, -1)
    attn = torch.softmax(torch.einsum("bnc,bmc->bnm", theta, phi), dim=-1)
    g = _pool2(conv2d(x, p["g"]["w"])).reshape(b, n // 4, -1)
    attn_g = torch.einsum("bnm,bmc->bnc", attn, g).reshape(b, h, w, -1)
    return p["gamma"] * conv2d(attn_g, p["o_conv"]["w"]) + x


def init(key, spec: BigGANSpec, device="cpu"):
    ks = prng.split(key, 8 + len(spec.blocks))
    # the GBlocks are conditioned on cat([20-wide chunk, 128-wide class
    # embedding]), the width the JAX package uses (the reference's
    # code_dim + 18 lines up only for a 100-wide input)
    z_dim = spec.z_per_chunk + 128
    chn = spec.chn
    return {
        "linear": _linear(ks[0], spec.n_class, 128, bias=False, device=device),
        "G_linear": _linear(ks[1], spec.z_per_chunk, 4 * 4 * 16 * chn, device=device),
        "GBlock": [_gblock_init(ks[2 + i], ci * chn, co * chn, z_dim, device)
                   for i, (ci, co) in enumerate(spec.blocks)],
        "attention": _attn_init(ks[6], 2 * chn, device),
        "bn": {"running_mean": torch.zeros(chn, device=device),
               "running_var": torch.ones(chn, device=device),
               "gamma": torch.ones(chn, device=device), "beta": torch.zeros(chn, device=device)},
        "colorize": _conv(ks[7], 3, chn, spec.n_channels, device=device),
    }


def _splits(spec: BigGANSpec, total_dim, variable_dim):
    if variable_dim:
        return [total_dim - (spec.num_split - 1) * 10] + [10] * (spec.num_split - 1)
    return [total_dim // spec.num_split] * spec.num_split


def apply(params, z, class_embedding, spec: BigGANSpec, variable_dim=False):
    """z: (B, D); class_embedding: (B, 128), or one-hot (B, n_class) through
    'linear'.  Returns (B, S, S, n_channels), in [-1, 1] for 3 channels."""
    if class_embedding.shape[-1] == spec.n_class:
        class_embedding = class_embedding @ params["linear"]["w"]
    codes = torch.split(z, _splits(spec, z.shape[-1], variable_dim), dim=-1)
    out = codes[0] @ params["G_linear"]["w"] + params["G_linear"]["b"]
    out = out.reshape(-1, 4, 4, 16 * spec.chn)
    for i, (code, gp) in enumerate(zip(codes[1:], params["GBlock"])):
        if i == spec.sa_id:
            out = _attn_apply(params["attention"], out)
        out = _gblock_apply(gp, out, torch.cat([code, class_embedding], dim=-1))
    bn = params["bn"]
    out = (out - bn["running_mean"]) / torch.sqrt(bn["running_var"] + 1e-4)
    out = F.relu(bn["gamma"] * out + bn["beta"])
    out = conv2d(out, params["colorize"]["w"], params["colorize"]["b"], padding=1)
    return torch.tanh(out) if spec.n_channels == 3 else out
