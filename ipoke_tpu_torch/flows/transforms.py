"""Elementwise invertible transforms inside the coupling and masked-conv
flows (counterpart of ``ipoke_tpu/flows/transforms.py``).

The port carries the affine family, the one every registry model uses.  The
other families (additive, relu, nlsq, symm_elu) wait in ROADMAP queue 1.
"""
from __future__ import annotations

import torch


def _sum_flat(x):
    return x.float().reshape(x.shape[0], -1).sum(dim=1)


class Affine:
    """scale = 1 + alpha * tanh(raw_logscale / 2); the inverse divides by
    (scale + 1e-12).  Params come channel-concatenated, mu first."""

    n_params = 2

    @staticmethod
    def calc_params(raw, alpha=1.0):
        mu, log_scale = torch.chunk(raw, 2, dim=-1)
        return mu, torch.tanh(log_scale * 0.5) * alpha + 1.0

    @staticmethod
    def fwd(z, params):
        mu, scale = params
        return scale * z + mu, _sum_flat(torch.log(scale))

    @staticmethod
    def bwd(z, params):
        mu, scale = params
        return (z - mu) / (scale + 1e-12), -_sum_flat(torch.log(scale))


TRANSFORMS = {"affine": Affine}


def get_transform(name):
    if name not in TRANSFORMS:
        raise NotImplementedError(
            f"transform {name!r} is not ported yet (ROADMAP.md queue 1, "
            f"variants and legacy flows); the port has: {sorted(TRANSFORMS)}"
        )
    return TRANSFORMS[name]
