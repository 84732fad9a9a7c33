"""ActNorm for 2D flows (counterpart of ``ipoke_tpu/flows/actnorm.py``).

fwd:  y = x * exp(log_scale) + bias,   logdet = H*W * sum(log_scale)
inv:  x = (y - bias) / (exp(log_scale) + 1e-8)
"""
from __future__ import annotations

import torch


def forward(p, x):
    b, h, w, _ = x.shape
    out = x * torch.exp(p["log_scale"].to(x.dtype)) + p["bias"].to(x.dtype)
    logdet = torch.full((b,), float(h * w), dtype=torch.float32, device=x.device)
    return out, logdet * p["log_scale"].float().sum()


def inverse(p, y):
    return (y - p["bias"].to(y.dtype)) / (torch.exp(p["log_scale"].to(y.dtype)) + 1e-8)
