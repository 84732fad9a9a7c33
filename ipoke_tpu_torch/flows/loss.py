"""Flow (NLL + logdet) losses (counterpart of ``ipoke_tpu/flows/loss.py``).

All reductions in f32.
"""
from __future__ import annotations

import math

import torch

from ipoke_tpu_torch.utils import prng


def nll(sample, spatial_mean=False):
    s = sample.float()
    if spatial_mean:   # mean over H, W, then sum over channels
        return 0.5 * (s * s).mean(dim=(1, 2)).sum(dim=-1)
    return 0.5 * (s.reshape(s.shape[0], -1) ** 2).sum(dim=1)


def flow_loss(sample, logdet, key=None, spatial_mean=False, logdet_weight=1.0):
    """Returns (loss, logs).  With a JAX ``key`` the logs also hold the
    calibration NLL of a standard-normal draw of the sample's shape."""
    nll_loss = nll(sample, spatial_mean).mean()
    nlogdet_loss = -logdet.float().mean()
    if spatial_mean:
        nlogdet_loss = nlogdet_loss / (sample.shape[1] * sample.shape[2])
    loss = nll_loss + logdet_weight * nlogdet_loss
    logs = {"flow_loss": loss, "nlogdet_loss": nlogdet_loss, "nll_loss": nll_loss,
            "logdet_weight": torch.tensor(logdet_weight, dtype=torch.float32)}
    if key is not None:
        ref = prng.normal(key, tuple(sample.shape), sample.device)
        logs["reference_nll_loss"] = nll(ref, spatial_mean).mean()
    return loss, logs


def gaussian_logp_loss(sample, logdet):
    """The GaussianLogP variant."""
    s = sample.float()
    nll_log_loss = (-0.5 * (s * s) - 0.5 * math.log(2 * math.pi)).sum() / s.shape[0]
    nlogdet = logdet.float().mean()
    loss = -(nll_log_loss + nlogdet)
    return loss, {"flow_loss": loss, "nll_log_loss": -nll_log_loss, "nlogdet_loss": -nlogdet}
