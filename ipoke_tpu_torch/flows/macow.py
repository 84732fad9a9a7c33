"""MaCow flow composition: MaCowUnit / MaCowStep / MultiScalePrior /
multiscale flow (counterpart of ``ipoke_tpu/flows/macow.py``).

Params are the JAX package's trees with one change: a level's MaCowSteps are
a list (``levels[i]["steps"][s]``) instead of one tree stacked on a leading
step axis.  ``forward`` returns ``(y, logdet[B])``; ``inverse`` is exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ipoke_tpu_torch.flows import actnorm, mcf, nice, permute
from ipoke_tpu_torch.flows.nice import nice_channels
from ipoke_tpu_torch.flows.transforms import get_transform
from ipoke_tpu_torch.ops.cuda.mcf_unit_inverse import macow_unit_inverse_cuda

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
    attention: bool = False
    cond_conv: bool = False
    # 'scan': plain loop; 'cuda': kernel K1 per MCF; 'cuda_unit': kernel K2
    # per MaCowUnit (the JAX 'scan' / 'pallas' / 'pallas_unit')
    mcf_backend: str = "scan"

    def __post_init__(self):
        get_transform(self.transform)
        get_transform(self.prior_transform)
        for opt in ("use_1x1", "condition_nice", "attention", "cond_conv"):
            if getattr(self, opt):
                raise NotImplementedError(
                    f"FlowSpec.{opt} is not ported yet (ROADMAP.md queue 1, "
                    f"spec options the registry does not use)")
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

def _mcf_kw(spec):
    return dict(transform=spec.transform, alpha=spec.alpha, act=spec.activation)


def macow_unit_forward(p, x, h, spec: FlowSpec):
    kw = _mcf_kw(spec)
    out, ld = mcf.forward(p["conv1"], x, h=h, order="A", **kw)
    out, l2 = mcf.forward(p["conv2"], out, h=h, order="B", **kw)
    out, l3 = actnorm.forward(p["actnorm1"], out)
    out, l4 = mcf.forward(p["conv3"], out, h=h, order="C", **kw)
    out, l5 = mcf.forward(p["conv4"], out, h=h, order="D", **kw)
    out, l6 = actnorm.forward(p["actnorm2"], out)
    return out, ld + l2 + l3 + l4 + l5 + l6


def macow_unit_inverse(p, y, h, spec: FlowSpec):
    if spec.mcf_backend == "cuda_unit":
        return macow_unit_inverse_cuda(p, y, h, spec)
    kw = dict(_mcf_kw(spec), backend=spec.mcf_backend)
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


def _nice(p, x, name, spec, inverse):
    split, order = _COUPLINGS[name]
    kw = dict(in_channels=x.shape[-1], factor=2, split_type=split, order=order,
              transform=spec.transform, alpha=spec.alpha, act=spec.activation)
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
        out, l = _nice(p, out, name, spec, inverse=False)
        ld = ld + l
    out, l = actnorm.forward(p["actnorm2"], out)
    ld = ld + l
    for unit in p["units2"]:
        out, l = macow_unit_forward(unit, out, h, spec)
        ld = ld + l
    for name in ("coupling2_up", "coupling2_dn"):
        out, l = _nice(p, out, name, spec, inverse=False)
        ld = ld + l
    return out, ld


def macow_step_inverse(p, y, h, spec: FlowSpec):
    out = _nice(p, y, "coupling2_dn", spec, inverse=True)
    out = _nice(p, out, "coupling2_up", spec, inverse=True)
    for unit in reversed(p["units2"]):
        out = macow_unit_inverse(unit, out, h, spec)
    out = actnorm.inverse(p["actnorm2"], out)
    out = _nice(p, out, "coupling1_dn", spec, inverse=True)
    out = _nice(p, out, "coupling1_up", spec, inverse=True)
    for unit in reversed(p["units1"]):
        out = macow_unit_inverse(unit, out, h, spec)
    out = permute.shuffle_inverse(p["conv1x1"], out)
    return actnorm.inverse(p["actnorm1"], out)


# ---------------------------------------------------------------------------
# MultiScalePrior: permutation -> NICE(cont, up, factor=level factor) -> ActNorm(z2)
# ---------------------------------------------------------------------------

def _prior_kw(c, level_factor, spec):
    return dict(in_channels=c, factor=level_factor, split_type="continuous", order="up",
                transform=spec.prior_transform, alpha=spec.alpha, act=spec.activation)


def prior_forward(p, x, h, level_factor, spec: FlowSpec):
    c = x.shape[-1]
    _, z1c, _, _ = nice_channels(c, level_factor, "continuous", "up")
    out, ld = permute.shuffle_forward(p["conv1x1"], x)
    out, l = nice.forward(p["coupling"], out, **_prior_kw(c, level_factor, spec))
    out2, l2 = actnorm.forward(p["actnorm"], out[..., z1c:])
    return torch.cat([out[..., :z1c], out2], dim=-1), ld + l + l2


def prior_inverse(p, y, h, level_factor, spec: FlowSpec):
    c = y.shape[-1]
    _, z1c, _, _ = nice_channels(c, level_factor, "continuous", "up")
    out = torch.cat([y[..., :z1c], actnorm.inverse(p["actnorm"], y[..., z1c:])], dim=-1)
    out = nice.inverse(p["coupling"], out, **_prior_kw(c, level_factor, spec))
    return permute.shuffle_inverse(p["conv1x1"], out)


# ---------------------------------------------------------------------------
# multiscale flow
# ---------------------------------------------------------------------------

def multiscale_forward(p, x, h, spec: FlowSpec):
    cs = spec.in_channels // spec.factor
    out = x
    ld = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    z2s = []
    for level, c, f in zip(p["levels"], spec.level_channels(), spec.level_factors()):
        for step in level["steps"]:
            out, l = macow_step_forward(step, out, h, spec)
            ld = ld + l
        out, l = prior_forward(level["prior"], out, h, f, spec)
        ld = ld + l
        out, l = permute.shuffle_forward(level["shuffle"], out)
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
        out = permute.shuffle_inverse(level["shuffle"], out)
        out = prior_inverse(level["prior"], out, h, f, spec)
        for step in reversed(level["steps"]):
            out = macow_step_inverse(step, out, h, spec)
    return out
