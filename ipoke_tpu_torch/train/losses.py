"""Shared training losses (counterpart of ``ipoke_tpu/train/losses.py``)."""
from __future__ import annotations

import torch


def kl_divergence(mu, logvar):
    """KL(N(mu, exp(logvar)) || N(0, 1)), summed over the channel (last)
    axis and averaged over the rest."""
    term = 1 + logvar - mu.square() - torch.exp(logvar)
    return -0.5 * torch.mean(term.sum(dim=-1))


def l1(a, b):
    return torch.mean((a - b).abs())
