"""Mixture-of-logistics CDF coupling flow (counterpart of
``ipoke_tpu/flows/mixcdf.py``); unused by the released configs.  The params
carry a trailing component axis K.

Per coupling: x2 -> logit(MixLogCDF(x2)) * e^s + t, with logdet
log MixLogPDF(x2) + s + logit'(.); the inverse bisects the CDF for a fixed
number of rounds on JAX's bracket.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.flows import actnorm, permute
from ipoke_tpu_torch.flows.legacy import inv_leaky_relu_forward, inv_leaky_relu_inverse
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import conv2d
from ipoke_tpu_torch.utils import prng


# -- logistic mixture math --------------------------------------------------

def _logistic_log_cdf(x, means, logscales):
    return F.logsigmoid((x - means) * torch.exp(-logscales))


def _logistic_log_pdf(x, means, logscales):
    z = (x - means) * torch.exp(-logscales)
    return z - logscales - 2.0 * F.softplus(z)


def mix_log_cdf(x, prior_logits, means, logscales):
    """x: (..., C); params: (..., C, K).  Returns the log CDF (..., C)."""
    prior = torch.log_softmax(prior_logits, dim=-1)
    return torch.logsumexp(prior + _logistic_log_cdf(x[..., None], means, logscales), dim=-1)


def mix_log_pdf(x, prior_logits, means, logscales):
    prior = torch.log_softmax(prior_logits, dim=-1)
    return torch.logsumexp(prior + _logistic_log_pdf(x[..., None], means, logscales), dim=-1)


def inv_mixlogcdf(y, prior_logits, means, logscales, n_iter=60):
    """``n_iter`` bisection rounds inverting exp(mix_log_cdf); y in (0, 1)."""
    maxscale = torch.exp(logscales).sum(dim=-1)
    lb = means.amin(dim=-1) - 50.0 * maxscale
    ub = means.amax(dim=-1) + 50.0 * maxscale
    x = torch.zeros_like(y)
    for _ in range(n_iter):
        gt = torch.exp(mix_log_cdf(x, prior_logits, means, logscales)) > y
        x, lb, ub = (torch.where(gt, (x + lb) * 0.5, (x + ub) * 0.5),
                     torch.where(gt, lb, x), torch.where(gt, x, ub))
    return x


# -- the logit (inverse of FLowSigmoid) -------------------------------------

def logit_forward(y):
    """x = log(y / (1 - y)), logdet = sum -log(y (1 - y))."""
    x = torch.log(y) - torch.log1p(-y)
    logdet = -torch.log(y) - torch.log1p(-y)
    return x, logdet.reshape(y.shape[0], -1).float().sum(dim=1)


def logit_inverse(x):
    return torch.sigmoid(x)


# -- parameter net: conv stack with a zero head (identity at init) ----------

@dataclass(frozen=True)
class MixCDFSpec:
    channels: int            # the block's channels, split in half
    hidden_dim: int
    components: int = 4
    n_flows: int = 2


def _init_param_net(key, c_in, hidden, c_out, device):
    k1, k2, _ = prng.split(key, 3)
    kern = lambda k, shape: core.from_hwio(core.kaiming_uniform_torch_default(k, shape, device))  # noqa: E731
    return {"conv1": {"w": kern(k1, (3, 3, c_in, hidden)), "b": torch.zeros(hidden, device=device)},
            "conv2": {"w": kern(k2, (1, 1, hidden, hidden)), "b": torch.zeros(hidden, device=device)},
            "out": {"w": torch.zeros((c_out, hidden, 3, 3), device=device),
                    "b": torch.zeros(c_out, device=device)}}


def _param_net_apply(p, x):
    h = F.leaky_relu(conv2d(x, p["conv1"]["w"], p["conv1"]["b"], padding=1), 0.01)
    h = F.leaky_relu(conv2d(h, p["conv2"]["w"], p["conv2"]["b"]), 0.01)
    return conv2d(h, p["out"]["w"], p["out"]["b"], padding=1)


def _split_params(raw, half, k):
    s, t = raw[..., :half], raw[..., half:2 * half]
    rest = raw[..., 2 * half:].reshape(tuple(raw.shape[:-1]) + (half, 3 * k))
    logits, means, logscales = rest.chunk(3, dim=-1)
    return torch.tanh(s), t, logits, means, logscales.clamp(-7.0, 7.0)


def init_coupling(key, spec: MixCDFSpec, device="cpu"):
    half = spec.channels // 2
    c_out = 2 * half + 3 * spec.components * half
    return {"net": _init_param_net(key, half, spec.hidden_dim, c_out, device)}


def coupling_forward(p, x, spec: MixCDFSpec):
    half = spec.channels // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, t, logits, means, logscales = _split_params(_param_net_apply(p["net"], x1), half,
                                                   spec.components)
    y2 = torch.exp(mix_log_cdf(x2, logits, means, logscales)).clamp(1e-5, 1.0 - 1e-5)
    y2, scale_ld = logit_forward(y2)
    y2 = y2 * torch.exp(s) + t
    logdet = mix_log_pdf(x2, logits, means, logscales) + s
    logdet = logdet.reshape(x.shape[0], -1).float().sum(dim=1) + scale_ld
    return torch.cat([x1, y2], dim=-1), logdet


def coupling_inverse(p, y, spec: MixCDFSpec):
    half = spec.channels // 2
    x1, y2 = y[..., :half], y[..., half:]
    s, t, logits, means, logscales = _split_params(_param_net_apply(p["net"], x1), half,
                                                   spec.components)
    x2 = logit_inverse(torch.exp(-s) * (y2 - t)).clamp(1e-5, 0.9999)
    return torch.cat([x1, inv_mixlogcdf(x2, logits, means, logscales)], dim=-1)


# -- flow block (ActNorm -> InvLeakyRelu -> coupling -> Shuffle) ------------

def init_flow(key, spec: MixCDFSpec, device="cpu"):
    blocks = []
    for i in range(spec.n_flows):
        kk = prng.fold_in(key, i)
        blocks.append({
            "actnorm": actnorm.init_actnorm(prng.fold_in(kk, 0), spec.channels, device),
            "coupling": init_coupling(prng.fold_in(kk, 1), spec, device),
            "shuffle": permute.init_shuffle(prng.fold_in(kk, 2), spec.channels, device),
        })
    return {"blocks": blocks}


def flow_forward(p, x, spec: MixCDFSpec):
    """x: (B,H,W,C).  Returns (z, logdet)."""
    logdet = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    h = x
    for blk in p["blocks"]:
        h, ld = actnorm.forward(blk["actnorm"], h)
        logdet = logdet + ld
        h, ld = inv_leaky_relu_forward(h)
        logdet = logdet + ld
        h, ld = coupling_forward(blk["coupling"], h, spec)
        logdet = logdet + ld
        h, _ = permute.shuffle_forward(blk["shuffle"], h)
    return h, logdet


def flow_inverse(p, z, spec: MixCDFSpec):
    h = z
    for blk in reversed(p["blocks"]):
        h = permute.shuffle_inverse(blk["shuffle"], h)
        h = coupling_inverse(blk["coupling"], h, spec)
        h = inv_leaky_relu_inverse(h)
        h = actnorm.inverse(blk["actnorm"], h)
    return h
