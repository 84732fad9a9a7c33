"""ActNorm for 2D flows (counterpart of ``ipoke_tpu/flows/actnorm.py``).

fwd:  y = x * exp(log_scale) + bias,   logdet = H*W * sum(log_scale)
inv:  x = (y - bias) / (exp(log_scale) + 1e-8)

``data_init`` is the explicit data-dependent init pass of the JAX package.
"""
from __future__ import annotations

import torch

from ipoke_tpu_torch.utils import prng


def init_actnorm(key, channels, device="cpu"):
    return {"log_scale": 0.05 * prng.normal(key, (channels,), device),
            "bias": torch.zeros(channels, device=device)}


def forward(p, x):
    b, h, w, _ = x.shape
    out = x * torch.exp(p["log_scale"].to(x.dtype)) + p["bias"].to(x.dtype)
    logdet = torch.full((b,), float(h * w), dtype=torch.float32, device=x.device)
    return out, logdet * p["log_scale"].float().sum()


def inverse(p, y):
    return (y - p["bias"].to(y.dtype)) / (torch.exp(p["log_scale"].to(y.dtype)) + 1e-8)


def data_init(p, x):
    """Params that give the post-actnorm activations zero mean and unit std
    per channel on the batch ``x``, composed with the current params."""
    out = x * torch.exp(p["log_scale"]) + p["bias"]
    flat = out.reshape(-1, out.shape[-1])
    inv_stdv = 1.0 / (flat.std(dim=0, unbiased=True) + 1e-6)
    return {"log_scale": p["log_scale"] + torch.log(inv_stdv),
            "bias": (p["bias"] - flat.mean(dim=0)) * inv_stdv}
