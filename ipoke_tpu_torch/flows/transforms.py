"""Elementwise invertible transforms inside the coupling and masked-conv
flows (counterpart of ``ipoke_tpu/flows/transforms.py``).

Params come from the subnet channel-concatenated, mu first, and are split on
the last axis.  logdet sums over every non-batch dim in float32.
"""
from __future__ import annotations

import math

import torch


def _sum_flat(x):
    return x.float().reshape(x.shape[0], -1).sum(dim=1)


def _zero_logdet(z):
    return torch.zeros((z.shape[0],), dtype=torch.float32, device=z.device)


class Additive:
    n_params = 1

    @staticmethod
    def calc_params(raw, alpha=1.0):
        return (raw,)

    @staticmethod
    def fwd(z, params):
        (mu,) = params
        return z + mu, _zero_logdet(z)

    @staticmethod
    def bwd(z, params):
        (mu,) = params
        return z - mu, _zero_logdet(z)


class Affine:
    """scale = 1 + alpha * tanh(raw_logscale / 2); the inverse divides by
    (scale + 1e-12)."""

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


class ReLUTransform:
    n_params = 2

    @staticmethod
    def calc_params(raw, alpha=1.0):
        mu, log_scale = torch.chunk(raw, 2, dim=-1)
        return mu, torch.tanh(log_scale)

    @staticmethod
    def fwd(z, params):
        mu, scale = params
        s = scale * (z > 0).to(z.dtype) + 1.0
        return s * z + mu, _sum_flat(torch.log(s))

    @staticmethod
    def bwd(z, params):
        mu, scale = params
        z = z - mu
        s = scale * (z > 0).to(z.dtype) + 1.0
        return z / (s + 1e-12), -_sum_flat(torch.log(s))


class SymmELU:
    """Forward only: neither the reference nor the JAX package has its
    inverse."""

    n_params = 2

    @staticmethod
    def calc_params(raw, alpha=1.0):
        mu, log_scale = torch.chunk(raw, 2, dim=-1)
        return mu, torch.tanh(log_scale * 0.5)

    @staticmethod
    def fwd(z, params):
        mu, scale = params
        tmp = torch.exp(-z.abs())
        return z - torch.sign(z) * scale * (tmp - 1.0) + mu, _sum_flat(torch.log(scale * tmp + 1.0))

    @staticmethod
    def bwd(z, params):
        raise NotImplementedError(
            "symm_elu has no inverse: the reference and the JAX package define its forward only")


class NLSQ:
    """Non-linear squared flow.  The inverse solves the cubic in closed form
    in f32 and polishes the root with three Newton steps on the forward map,
    as the JAX package does (the reference solves it in f64)."""

    n_params = 5
    logA = math.log(8 * math.sqrt(3) / 9 - 0.05)

    @staticmethod
    def calc_params(raw, alpha=1.0):
        a, logb, cprime, logd, g = torch.chunk(raw, 5, dim=-1)
        logb = logb * 0.4
        cprime = cprime * 0.3
        logd = logd * 0.4
        c = torch.exp(NLSQ.logA + logb - logd) * torch.tanh(cprime)
        return a, torch.exp(logb), c, torch.exp(logd), g

    @staticmethod
    def fwd(z, params):
        a, b, c, d, g = params
        arg = d * z + g
        denom = arg * arg + 1.0
        cd = c / denom
        return b * z + a + cd, _sum_flat(torch.log(b - 2.0 * cd * d * arg / denom))

    @staticmethod
    def bwd(z, params):
        a, b, c, d, g = params
        aa = -b * d * d
        bb = (z - a) * d * d - 2.0 * b * d * g
        cc = (z - a) * 2.0 * d * g - b * (1.0 + g * g)
        dd = (z - a) * (1.0 + g * g) - c
        p = (3.0 * aa * cc - bb * bb) / (3.0 * aa * aa)
        q = (2.0 * bb ** 3 - 9.0 * aa * bb * cc + 27.0 * aa * aa * dd) / (27.0 * aa ** 3)
        absp = p.abs()
        t_neg = -2.0 * torch.sign(q) * torch.sqrt(absp / 3.0)
        i1 = -3.0 * q.abs() / (2.0 * p) * torch.sqrt(3.0 / absp)
        t_neg = t_neg * torch.cosh(torch.acosh((i1 - 1.0).abs() + 1.0) / 3.0)
        j1 = 3.0 * q / (2.0 * p) * torch.sqrt(3.0 / absp)
        t_pos = -2.0 * torch.sqrt(absp / 3.0) * torch.sinh(torch.asinh(j1) / 3.0)
        zz = torch.where(p > 0, t_pos, t_neg) - bb / (3.0 * aa)
        # a degenerate cubic (p ~ 0) can seed NaN/inf: the linear inverse
        # there; Newton below reaches the root either way
        zz = torch.where(torch.isfinite(zz), zz, (z - a) / b)
        for _ in range(3):
            arg = d * zz + g
            denom = arg * arg + 1.0
            resid = b * zz + a + c / denom - z
            zz = zz - resid / (b - 2.0 * c * d * arg / (denom * denom))
        arg = d * zz + g
        denom = arg * arg + 1.0
        return zz, -_sum_flat(torch.log(b - 2.0 * c * d * arg / (denom * denom)))


TRANSFORMS = {
    "additive": Additive,
    "affine": Affine,
    "relu": ReLUTransform,
    "nlsq": NLSQ,
    "symm_elu": SymmELU,
}


def get_transform(name):
    if name not in TRANSFORMS:
        raise ValueError(f"transform {name!r} not in {sorted(TRANSFORMS)}")
    return TRANSFORMS[name]
