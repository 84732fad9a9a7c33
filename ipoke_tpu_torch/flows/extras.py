"""The reference's remaining flow modules (counterpart of
``ipoke_tpu/flows/extras.py``): GIN (volume-preserving) ActNorm, the
MADE-masked autoregressive fully connected net, and NIN (a 1x1 channel
linear with a data-dependent init).  Unused by the released configs.
"""
from __future__ import annotations

import numpy as np
import torch

from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.utils import prng


# -- GIN ActNorm: the last channel's scale is the inverse product of the
#    others, so det == 1 and the logdet is zero ------------------------------

def init_gin_actnorm(channels, device="cpu"):
    return {"loc": torch.zeros(channels, device=device),
            "scale": torch.ones(channels, device=device)}


def _gin_scale(p):
    scale = p["scale"][:-1]
    return torch.cat([scale, (1.0 / (torch.prod(scale) + 1e-6))[None]])


def gin_actnorm_forward(p, x):
    """x: (..., C).  Volume-preserving: logdet = 0."""
    return (_gin_scale(p) * (x + p["loc"]),
            torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device))


def gin_actnorm_inverse(p, y):
    return y / _gin_scale(p) - p["loc"]


def gin_actnorm_data_init(p, x, alpha=1.0):
    flat = x.reshape(-1, x.shape[-1])
    return {"loc": -flat.mean(dim=0), "scale": alpha / (flat.std(dim=0, unbiased=False) + 1e-6)}


# -- MADE masked autoregressive FC net --------------------------------------

def made_masks(nin, hidden_sizes, nout, seed=0, natural_ordering=True):
    """The connectivity masks of an autoregressive MLP (MADE), each (in, out),
    from numpy's ``default_rng(seed)`` as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    degrees = [np.arange(nin) if natural_ordering else rng.permutation(nin)]
    for h in hidden_sizes:
        low = degrees[-1].min()
        degrees.append(rng.integers(low, nin - 1, size=h) if nin > 1 else np.zeros(h, np.int64))
    masks = [degrees[i + 1][:, None] >= degrees[i][None, :] for i in range(len(hidden_sizes))]
    out_deg = np.concatenate([degrees[0]] * (nout // nin))
    masks.append(out_deg[:, None] > degrees[-1][None, :])
    return [m.T.astype(np.float32) for m in masks]


def init_ar_fc_net(key, nin, hidden_sizes, nout, seed=0, device="cpu"):
    sizes = [nin] + list(hidden_sizes) + [nout]
    masks = made_masks(nin, list(hidden_sizes), nout, seed=seed)
    return {"layers": [
        {"w": core.kaiming_uniform_torch_default(prng.fold_in(key, i), (ci, co), device),
         "b": torch.zeros(co, device=device),
         "mask": torch.from_numpy(masks[i]).to(device)}
        for i, (ci, co) in enumerate(zip(sizes, sizes[1:]))]}


def ar_fc_net_apply(p, x):
    h = x
    for i, layer in enumerate(p["layers"]):
        h = h @ (layer["w"] * layer["mask"]) + layer["b"]
        if i < len(p["layers"]) - 1:
            h = torch.relu(h)
    return h


def ar_jacobian_is_triangular(p, x):
    """Whether output i depends on no input >= i in each nout/nin chunk: the
    autoregressive property the masks give.  x: (nin,)."""
    jac = torch.autograd.functional.jacobian(lambda v: ar_fc_net_apply(p, v[None])[0], x)
    nin = x.shape[0]
    return all(bool(torch.all(torch.triu(jac[c * nin:(c + 1) * nin]) == 0))
               for c in range(jac.shape[0] // nin))


# -- NIN: 1x1 channel linear with a data-dependent init ---------------------

def init_nin(key, in_units, out_units, initializer="xavier", device="cpu"):
    if initializer == "zeros":
        w = torch.zeros((in_units, out_units), device=device)
    elif initializer == "xavier":
        std = float(np.sqrt(2.0 / (in_units + out_units)))
        w = std * prng.normal(key, (in_units, out_units), device)
    else:   # 'data': random, then nin_data_init on the first batch
        w = prng.normal(key, (in_units, out_units), device)
    return {"w": w, "b": torch.zeros(out_units, device=device)}


def nin_apply(p, x):
    """x: (B, H, W, C_in) -> (B, H, W, C_out)."""
    return x @ p["w"] + p["b"]


def nin_data_init(p, x):
    y = x.reshape(-1, x.shape[-1]) @ p["w"]
    scale = 1.0 / torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
    return {"w": p["w"] * scale[None], "b": -y.mean(dim=0) * scale}

