"""MaCow flow composition: MaCowUnit / MaCowStep / MultiScalePrior /
multiscale flow (counterpart of ``ipoke_tpu/flows/macow.py``).

Params are the JAX package's trees with one change: a level's MaCowSteps are
a list (``levels[i]["steps"][s]``) instead of one tree stacked on a leading
step axis.  ``forward`` returns ``(y, logdet[B])``; ``inverse`` is exact.
The ``init_*`` functions draw JAX's params from JAX's key.

Spec options, as in JAX: ``cond_conv`` puts a gated conv on h before each
MaCowUnit (``cond_conv_block``; K2 then reads the gated h); ``condition_nice``
feeds h to every NICE coupling; ``attention`` makes the couplings' subnets
attention blocks; ``use_1x1`` makes the priors' and the levels'
permutations conv-LU 1x1 convs (the steps' ``conv1x1`` stays a shuffle);
``remat`` checkpoints each MaCowStep of the forward while grad is enabled
(``torch.utils.checkpoint``; JAX's ``jax.checkpoint`` of the scanned step
body), so the backward recomputes a step's activations instead of keeping
them; the inverse ignores it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ipoke_tpu_torch.flows import actnorm, attention, mcf, nice, permute
from ipoke_tpu_torch.flows.nice import nice_channels
from ipoke_tpu_torch.flows.transforms import get_transform
from ipoke_tpu_torch.ops.cuda.mcf_unit_inverse import macow_unit_inverse_cuda
from ipoke_tpu_torch.utils import prng

MCF_BACKENDS = ("scan", "cuda", "cuda_unit")


@dataclass(frozen=True)
class FlowSpec:
    num_steps: Tuple[int, ...]
    in_channels: int
    hidden_channels: int
    h_channels: int
    factor: int = 16
    transform: str = "affine"
    prior_transform: str = "affine"
    alpha: float = 1.0
    kernel_size: Tuple[int, int] = (2, 3)
    activation: str = "elu"
    use_1x1: bool = False
    condition_nice: bool = False
    attention: bool = False      # attention NICE subnets
    heads: int = 4               # their attention heads
    spatial_size: int = 8        # their positional embedding's and layer norm's H = W
    cond_conv: bool = False      # a gated conv on h before each MaCowUnit
    remat: bool = False          # checkpoint each MaCowStep of the forward
    # 'scan': plain loop; 'cuda': kernel K1 per MCF; 'cuda_unit': kernel K2
    # per MaCowUnit (the JAX 'scan' / 'pallas' / 'pallas_unit'); a
    # non-affine transform takes the plain loop on each, as in JAX
    mcf_backend: str = "scan"

    def __post_init__(self):
        get_transform(self.transform)
        get_transform(self.prior_transform)
        if self.mcf_backend not in MCF_BACKENDS:
            raise ValueError(f"mcf_backend {self.mcf_backend!r} not in {MCF_BACKENDS}")

    def level_channels(self) -> List[int]:
        cs = self.in_channels // self.factor
        return [self.in_channels - i * cs for i in range(len(self.num_steps))]

    def level_factors(self) -> List[int]:
        return [self.factor - i for i in range(len(self.num_steps))]


# ---------------------------------------------------------------------------
# MaCowUnit: MCF(A) -> MCF(B) -> ActNorm -> MCF(C) -> MCF(D) -> ActNorm
# ---------------------------------------------------------------------------

def init_macow_unit(key, c, spec: FlowSpec, device="cpu"):
    ks = prng.split(key, 7)
    kh, kw = spec.kernel_size
    hc = spec.h_channels or None
    kw_ = dict(h_channels=hc, transform=spec.transform, device=device)
    p = {}
    if spec.cond_conv and hc:
        p["cond_conv_block"] = attention.init_gated_conv(ks[6], hc, device=device)
    p.update({
        "conv1": mcf.init_mcf(ks[0], c, (kh, kw), **kw_),
        "conv2": mcf.init_mcf(ks[1], c, (kh, kw), **kw_),
        "actnorm1": actnorm.init_actnorm(ks[2], c, device),
        "conv3": mcf.init_mcf(ks[3], c, (kw, kh), **kw_),
        "conv4": mcf.init_mcf(ks[4], c, (kw, kh), **kw_),
        "actnorm2": actnorm.init_actnorm(ks[5], c, device),
    })
    return p


def _unit_h(p, h):
    """h through the unit's gated conv, where it has one (``cond_conv``)."""
    if "cond_conv_block" in p and h is not None:
        return attention.gated_conv_apply(p["cond_conv_block"], h)
    return h


def _mcf_kw(spec):
    return dict(transform=spec.transform, alpha=spec.alpha, act=spec.activation)


def macow_unit_forward(p, x, h, spec: FlowSpec):
    kw = _mcf_kw(spec)
    h = _unit_h(p, h)
    out, ld = mcf.forward(p["conv1"], x, h=h, order="A", **kw)
    out, l2 = mcf.forward(p["conv2"], out, h=h, order="B", **kw)
    out, l3 = actnorm.forward(p["actnorm1"], out)
    out, l4 = mcf.forward(p["conv3"], out, h=h, order="C", **kw)
    out, l5 = mcf.forward(p["conv4"], out, h=h, order="D", **kw)
    out, l6 = actnorm.forward(p["actnorm2"], out)
    return out, ld + l2 + l3 + l4 + l5 + l6


def macow_unit_inverse(p, y, h, spec: FlowSpec):
    """K2 on ``'cuda_unit'`` for the affine transform; the MCFs one by one
    otherwise, a non-affine transform on the plain loop (JAX's route)."""
    h = _unit_h(p, h)
    if spec.mcf_backend == "cuda_unit" and spec.transform == "affine":
        return macow_unit_inverse_cuda(p, y, h, spec)
    backend = "scan" if spec.mcf_backend == "cuda_unit" else spec.mcf_backend
    kw = dict(_mcf_kw(spec), backend=backend)
    out = actnorm.inverse(p["actnorm2"], y)
    out = mcf.inverse(p["conv4"], out, h=h, order="D", **kw)
    out = mcf.inverse(p["conv3"], out, h=h, order="C", **kw)
    out = actnorm.inverse(p["actnorm1"], out)
    out = mcf.inverse(p["conv2"], out, h=h, order="B", **kw)
    return mcf.inverse(p["conv1"], out, h=h, order="A", **kw)


# ---------------------------------------------------------------------------
# MaCowStep
# ---------------------------------------------------------------------------

# NICE split and order of the step's four couplings
_COUPLINGS = {
    "coupling1_up": ("continuous", "up"),
    "coupling1_dn": ("continuous", "down"),
    "coupling2_up": ("skip", "up"),
    "coupling2_dn": ("skip", "down"),
}


def _nice_init_kw(spec: FlowSpec):
    return dict(hidden=spec.hidden_channels,
                h_channels=spec.h_channels if spec.condition_nice else 0,
                attention=spec.attention, heads=spec.heads, spatial_size=spec.spatial_size)


def init_macow_step(key, c, spec: FlowSpec, device="cpu"):
    ks = prng.split(key, 10)

    def coupling(k, name):
        split, order = _COUPLINGS[name]
        return nice.init_nice(k, c, split_type=split, order=order, transform=spec.transform,
                              device=device, **_nice_init_kw(spec))

    return {
        "actnorm1": actnorm.init_actnorm(ks[0], c, device),
        "conv1x1": permute.init_shuffle(ks[1], c, device),
        "units1": [init_macow_unit(ks[2], c, spec, device), init_macow_unit(ks[3], c, spec, device)],
        "coupling1_up": coupling(ks[4], "coupling1_up"),
        "coupling1_dn": coupling(ks[5], "coupling1_dn"),
        "actnorm2": actnorm.init_actnorm(ks[6], c, device),
        "units2": [init_macow_unit(ks[7], c, spec, device), init_macow_unit(ks[8], c, spec, device)],
        "coupling2_up": coupling(ks[9], "coupling2_up"),
        "coupling2_dn": coupling(prng.fold_in(key, 11), "coupling2_dn"),
    }


def _nice(p, x, h, name, spec, inverse):
    split, order = _COUPLINGS[name]
    kw = dict(h=h if spec.condition_nice else None, in_channels=x.shape[-1], factor=2,
              split_type=split, order=order, transform=spec.transform, alpha=spec.alpha,
              act=spec.activation, heads=spec.heads)
    if inverse:
        return nice.inverse(p[name], x, **kw)
    return nice.forward(p[name], x, **kw)


def macow_step_forward(p, x, h, spec: FlowSpec):
    out, ld = actnorm.forward(p["actnorm1"], x)
    out, l = permute.shuffle_forward(p["conv1x1"], out)
    ld = ld + l
    for unit in p["units1"]:
        out, l = macow_unit_forward(unit, out, h, spec)
        ld = ld + l
    for name in ("coupling1_up", "coupling1_dn"):
        out, l = _nice(p, out, h, name, spec, inverse=False)
        ld = ld + l
    out, l = actnorm.forward(p["actnorm2"], out)
    ld = ld + l
    for unit in p["units2"]:
        out, l = macow_unit_forward(unit, out, h, spec)
        ld = ld + l
    for name in ("coupling2_up", "coupling2_dn"):
        out, l = _nice(p, out, h, name, spec, inverse=False)
        ld = ld + l
    return out, ld


def macow_step_inverse(p, y, h, spec: FlowSpec):
    out = _nice(p, y, h, "coupling2_dn", spec, inverse=True)
    out = _nice(p, out, h, "coupling2_up", spec, inverse=True)
    for unit in reversed(p["units2"]):
        out = macow_unit_inverse(unit, out, h, spec)
    out = actnorm.inverse(p["actnorm2"], out)
    out = _nice(p, out, h, "coupling1_dn", spec, inverse=True)
    out = _nice(p, out, h, "coupling1_up", spec, inverse=True)
    for unit in reversed(p["units1"]):
        out = macow_unit_inverse(unit, out, h, spec)
    out = permute.shuffle_inverse(p["conv1x1"], out)
    return actnorm.inverse(p["actnorm1"], out)


# ---------------------------------------------------------------------------
# MultiScalePrior: permutation -> NICE(cont, up, factor=level factor) -> ActNorm(z2)
# ---------------------------------------------------------------------------

def _init_perm(key, c, spec: FlowSpec, device):
    if spec.use_1x1:
        return permute.init_conv_lu(key, c, device)
    return permute.init_shuffle(key, c, device)


def _perm_fwd(p, x, spec: FlowSpec):
    if spec.use_1x1:
        return permute.conv_lu_forward(p, x)
    return permute.shuffle_forward(p, x)


def _perm_inv(p, y, spec: FlowSpec):
    if spec.use_1x1:
        return permute.conv_lu_inverse(p, y)
    return permute.shuffle_inverse(p, y)


def init_prior(key, c, level_factor, spec: FlowSpec, device="cpu"):
    k1, k2, k3 = prng.split(key, 3)
    _, z1c, _, _ = nice_channels(c, level_factor, "continuous", "up")
    return {
        "conv1x1": _init_perm(k1, c, spec, device),
        "coupling": nice.init_nice(k2, c, split_type="continuous", order="up",
                                   factor=level_factor, transform=spec.prior_transform,
                                   device=device, **_nice_init_kw(spec)),
        "actnorm": actnorm.init_actnorm(k3, c - z1c, device),
    }


def _prior_kw(c, h, level_factor, spec):
    # no ``heads``: JAX's prior couplings run at nice's default of 4 heads
    return dict(h=h if spec.condition_nice else None, in_channels=c, factor=level_factor,
                split_type="continuous", order="up", transform=spec.prior_transform,
                alpha=spec.alpha, act=spec.activation)


def prior_forward(p, x, h, level_factor, spec: FlowSpec):
    c = x.shape[-1]
    _, z1c, _, _ = nice_channels(c, level_factor, "continuous", "up")
    out, ld = _perm_fwd(p["conv1x1"], x, spec)
    out, l = nice.forward(p["coupling"], out, **_prior_kw(c, h, level_factor, spec))
    out2, l2 = actnorm.forward(p["actnorm"], out[..., z1c:])
    return torch.cat([out[..., :z1c], out2], dim=-1), ld + l + l2


def prior_inverse(p, y, h, level_factor, spec: FlowSpec):
    c = y.shape[-1]
    _, z1c, _, _ = nice_channels(c, level_factor, "continuous", "up")
    out = torch.cat([y[..., :z1c], actnorm.inverse(p["actnorm"], y[..., z1c:])], dim=-1)
    out = nice.inverse(p["coupling"], out, **_prior_kw(c, h, level_factor, spec))
    return _perm_inv(p["conv1x1"], out, spec)


# ---------------------------------------------------------------------------
# multiscale flow
# ---------------------------------------------------------------------------

def init_level(key, i, c, f, n_steps, spec: FlowSpec, device="cpu"):
    """Level ``i``: its steps from ``fold_in(fold_in(key, i), 100 + s)``, the
    prior from ``.., 1)``, the permutation from ``.., 2)``, as JAX keys them."""
    kk = prng.fold_in(key, i)
    return {
        "steps": [init_macow_step(prng.fold_in(kk, 100 + s), c, spec, device)
                  for s in range(n_steps)],
        "prior": init_prior(prng.fold_in(kk, 1), c, f, spec, device),
        "shuffle": _init_perm(prng.fold_in(kk, 2), c, spec, device),
    }


def init_multiscale(key, spec: FlowSpec, device="cpu"):
    return {"levels": [init_level(key, i, c, f, n, spec, device) for i, (c, f, n) in enumerate(
        zip(spec.level_channels(), spec.level_factors(), spec.num_steps))]}


def steps_forward(steps, x, h, spec: FlowSpec):
    """A level's MaCowSteps in order: (out, logdet[B]); each step under
    ``torch.utils.checkpoint`` when ``spec.remat`` and grad is enabled."""
    remat = spec.remat and torch.is_grad_enabled()
    out = x
    ld = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for step in steps:
        if remat:
            out, l = checkpoint(macow_step_forward, step, out, h, spec, use_reentrant=False)
        else:
            out, l = macow_step_forward(step, out, h, spec)
        ld = ld + l
    return out, ld


def level_forward(level, x, h, c, f, spec: FlowSpec):
    """One multi-scale level: steps -> prior -> permutation -> split, as
    JAX's ``train/chunked._level_forward``.  Returns (z1 carry, z2,
    logdet[B])."""
    cs = spec.in_channels // spec.factor
    out, ld = steps_forward(level["steps"], x, h, spec)
    out, l = prior_forward(level["prior"], out, h, f, spec)
    ld = ld + l
    out, l = _perm_fwd(level["shuffle"], out, spec)
    return out[..., :c - cs], out[..., c - cs:], ld + l


def multiscale_forward(p, x, h, spec: FlowSpec):
    cs = spec.in_channels // spec.factor
    out = x
    ld = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    z2s = []
    for level, c, f in zip(p["levels"], spec.level_channels(), spec.level_factors()):
        out, l = steps_forward(level["steps"], out, h, spec)
        ld = ld + l
        out, l = prior_forward(level["prior"], out, h, f, spec)
        ld = ld + l
        out, l = _perm_fwd(level["shuffle"], out, spec)
        ld = ld + l
        z2s.append(out[..., c - cs:])
        out = out[..., :c - cs]
    return torch.cat([out] + z2s[::-1], dim=-1), ld


def multiscale_inverse(p, y, h, spec: FlowSpec):
    chans = spec.level_channels()
    cs = spec.in_channels // spec.factor
    # peel off the z2 splits in forward order
    out = y
    z2s = []
    for c in chans:
        z2s.append(out[..., c - cs:c])
        out = out[..., :c - cs]
    for level, f, z2 in zip(reversed(p["levels"]), reversed(spec.level_factors()), reversed(z2s)):
        out = torch.cat([out, z2], dim=-1)
        out = _perm_inv(level["shuffle"], out, spec)
        out = prior_inverse(level["prior"], out, h, f, spec)
        for step in reversed(level["steps"]):
            out = macow_step_inverse(step, out, h, spec)
    return out
