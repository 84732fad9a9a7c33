"""Fully connected coupling flows, the flow family before MaCow (counterpart
of ``ipoke_tpu/flows/legacy.py``).  No released config uses them; they are
here for the reference's older checkpoints (``ckpt/torch_import.convert_fc_flow``).

Vectors are (B, C).  A fully connected net keeps JAX's linear layout
``w: (in, out)`` and its ``use_tanh`` flag as a bool leaf; the conditioning
layers are 1x1 convs in the port's OIHW layout, applied to vectors as matmuls.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.flows import permute
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class FCFlowSpec:
    in_channels: int
    embedding_dim: int
    hidden_dim: int
    hidden_depth: int
    n_flows: int
    conditioning_option: str = "none"   # none | parallel | sequential
    activation: str = "lrelu"           # lrelu | none


# -- BasicFullyConnectedNet -------------------------------------------------

def init_fc_net(key, dim, depth, hidden_dim, out_dim, use_tanh, device="cpu"):
    ks = prng.split(key, depth + 2)
    sizes = [(dim, hidden_dim)] + [(hidden_dim, hidden_dim)] * depth + [(hidden_dim, out_dim)]
    layers = [{"w": core.kaiming_uniform_torch_default(k, (ci, co), device),
               "b": core.conv_bias_torch_default(prng.fold_in(k, 1), (ci, co), co, device)}
              for k, (ci, co) in zip(ks, sizes)]
    return {"layers": layers, "use_tanh": bool(use_tanh)}


def fc_net_apply(p, x):
    h = x
    for i, layer in enumerate(p["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(p["layers"]) - 1:
            h = F.leaky_relu(h, 0.01)
    return torch.tanh(h) if p["use_tanh"] else h


# -- vector ActNorm ---------------------------------------------------------

def init_vec_actnorm(channels, device="cpu"):
    return {"loc": torch.zeros(channels, device=device),
            "scale": torch.ones(channels, device=device)}


def vec_actnorm_forward(p, x):
    y = p["scale"] * (x + p["loc"])
    logdet = torch.log(p["scale"].abs()).sum().float().expand(x.shape[0])
    return y, logdet


def vec_actnorm_inverse(p, y):
    return y / p["scale"] - p["loc"]


def vec_actnorm_data_init(p, x):
    """loc = -mean, scale = 1 / (std + 1e-6) of the batch ``x``."""
    return {"loc": -x.mean(dim=0), "scale": 1.0 / (x.std(dim=0, unbiased=False) + 1e-6)}


# -- invertible leaky relu --------------------------------------------------

def inv_leaky_relu_forward(x, alpha=0.9):
    y = torch.where(x >= 0, x, x * alpha)
    return y, torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


def inv_leaky_relu_inverse(y, alpha=0.9):
    return torch.where(y >= 0, y, y / alpha)


# -- double vector coupling -------------------------------------------------

def init_double_coupling(key, in_channels, cond_channels, hidden_dim, depth, mode,
                         device="cpu"):
    """mode 'normal': the conditioner reads cat([x_half, cond]); 'cond': cond only."""
    half = in_channels // 2
    in_dim = cond_channels if mode == "cond" else half + cond_channels
    ks = prng.split(key, 4)
    net = lambda k, tanh: init_fc_net(k, in_dim, depth, hidden_dim, half, tanh, device)  # noqa: E731
    return {"s": [net(ks[0], True), net(ks[1], True)],
            "t": [net(ks[2], False), net(ks[3], False)]}


def _coupling_in(x_apply, xc, mode):
    return xc if mode == "cond" else torch.cat([x_apply, xc], dim=1)


def _swap(x):
    a, b = x.chunk(2, dim=1)
    return torch.cat([b, a], dim=1)


def double_coupling_forward(p, x, xc, mode="normal"):
    logdet = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for i in range(2):
        if i % 2:
            x = _swap(x)
        xa, xk = x.chunk(2, dim=1)
        ci = _coupling_in(xa, xc, mode)
        scale = fc_net_apply(p["s"][i], ci)
        xk = xk * torch.exp(scale) + fc_net_apply(p["t"][i], ci)
        x = torch.cat([xa, xk], dim=1)
        logdet = logdet + scale.float().sum(dim=1)
    return x, logdet


def double_coupling_inverse(p, y, xc, mode="normal"):
    x = y
    for i in reversed(range(2)):
        if i % 2 == 0:
            x = _swap(x)
        xa, xk = x.chunk(2, dim=1)
        ci = _coupling_in(xa, xc, mode)
        xk = (xk - fc_net_apply(p["t"][i], ci)) * torch.exp(-fc_net_apply(p["s"][i], ci))
        x = torch.cat([xa, xk], dim=1)
    return x


# -- flow block + stack -----------------------------------------------------

def _mode(i):
    return "cond" if i % 2 == 0 else "normal"


def init_fc_flow(key, spec: FCFlowSpec, device="cpu"):
    blocks = []
    for i in range(spec.n_flows):
        kk = prng.fold_in(key, i)
        blocks.append({
            "actnorm": init_vec_actnorm(spec.in_channels, device),
            "coupling": init_double_coupling(prng.fold_in(kk, 1), spec.in_channels,
                                             spec.embedding_dim, spec.hidden_dim,
                                             spec.hidden_depth, _mode(i), device),
            "shuffle": permute.init_shuffle(prng.fold_in(kk, 2), spec.in_channels, device),
        })
    p = {"blocks": blocks}
    if spec.conditioning_option != "none":
        e = spec.embedding_dim
        p["cond_layers"] = [
            {"w": core.from_hwio(core.kaiming_uniform_torch_default(
                prng.fold_in(key, 1000 + i), (1, 1, e, e), device)),
             "b": torch.zeros(e, device=device)}
            for i in range(spec.n_flows)]
    return p


def _hconds(p, spec: FCFlowSpec, embedding):
    """Per-block conditioning embeddings (the 1x1 convs act on vectors)."""
    hconds, h = [], embedding
    for i in range(spec.n_flows):
        if spec.conditioning_option in ("parallel", "sequential"):
            cl = p["cond_layers"][i]
            src = embedding if spec.conditioning_option == "parallel" else h
            h = src @ cl["w"][:, :, 0, 0].T + cl["b"]
        hconds.append(h)
    return hconds


def fc_flow_forward(p, spec: FCFlowSpec, x, embedding):
    """x: (B, C); embedding: (B, E).  Returns (z, logdet)."""
    hconds = _hconds(p, spec, embedding)
    logdet = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    h = x
    for i, blk in enumerate(p["blocks"]):
        h, ld = vec_actnorm_forward(blk["actnorm"], h)
        logdet = logdet + ld
        if spec.activation == "lrelu":
            h, ld = inv_leaky_relu_forward(h)
            logdet = logdet + ld
        h, ld = double_coupling_forward(blk["coupling"], h, hconds[i], _mode(i))
        logdet = logdet + ld
        h, _ = permute.shuffle_forward(blk["shuffle"], h)
    return h, logdet


def fc_flow_inverse(p, spec: FCFlowSpec, z, embedding):
    hconds = _hconds(p, spec, embedding)
    h = z
    for i in reversed(range(spec.n_flows)):
        blk = p["blocks"][i]
        h = permute.shuffle_inverse(blk["shuffle"], h)
        h = double_coupling_inverse(blk["coupling"], h, hconds[i], _mode(i))
        if spec.activation == "lrelu":
            h = inv_leaky_relu_inverse(h)
        h = vec_actnorm_inverse(blk["actnorm"], h)
    return h


def fc_flow_sample(p, spec: FCFlowSpec, key, embedding):
    """z ~ N(0, I) from the JAX key ``key``, through the inverse."""
    z = prng.normal(key, (embedding.shape[0], spec.in_channels), embedding.device)
    return fc_flow_inverse(p, spec, z.to(embedding.dtype), embedding)
