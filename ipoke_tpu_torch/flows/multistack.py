"""MultiscaleStack (counterpart of ``ipoke_tpu/flows/multistack.py``):
several multiscale flows in a row, with a space-to-depth (``down``) or
depth-to-space (``up``) reshape before the block at the midpoint and, from
there on, a conditioning transform of h per block (a stride-2 conv for
``down``, a stride-2 transpose conv for ``up``, each with GroupNorm).

Params: ``{"blocks": [multiscale flow per block], "h_transforms": [...]}``,
``h_transforms`` only with a reshape and h.  An ``up`` transform's kernel is
the transpose conv's ``(in, out, kh, kw)``; JAX draws it as a plain conv
(``init_conv2d_block``) and reads it in its transpose conv as drawn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ipoke_tpu_torch.flows import macow
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.nn import blocks
from ipoke_tpu_torch.nn.core import depth_to_space, space_to_depth
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class StackSpec:
    levels: Tuple[Tuple[int, ...], ...]   # per-block num_steps
    factors: Tuple[int, ...]              # per-block multiscale factor
    in_channels: int
    mid_channels_factor: int
    h_channels: int
    reshape: str = "none"                 # 'none' | 'up' | 'down'
    transform: str = "affine"
    prior_transform: str = "affine"
    kernel_size: Tuple[int, int] = (2, 3)
    activation: str = "elu"
    use_1x1: bool = False
    condition_nice: bool = False
    mcf_backend: str = "scan"

    def __post_init__(self):
        if self.reshape not in ("none", "up", "down"):
            raise ValueError(f"reshape {self.reshape!r} not in ('none', 'up', 'down')")

    @property
    def reshape_step(self):
        return len(self.levels) // 2

    def block_specs(self) -> List[FlowSpec]:
        """Each block's FlowSpec: as JAX builds them, without ``attention``
        or ``cond_conv``, hidden ``mid_channels_factor`` times its channels."""
        specs = []
        c = self.in_channels
        for i, (steps, f) in enumerate(zip(self.levels, self.factors)):
            if self.reshape != "none" and i == self.reshape_step:
                c = c * 4 if self.reshape == "down" else c // 4
            specs.append(FlowSpec(
                num_steps=tuple(steps), in_channels=c,
                hidden_channels=c * self.mid_channels_factor, h_channels=self.h_channels,
                factor=f, transform=self.transform, prior_transform=self.prior_transform,
                kernel_size=self.kernel_size, activation=self.activation,
                use_1x1=self.use_1x1, condition_nice=self.condition_nice,
                mcf_backend=self.mcf_backend))
        return specs


def _transforms_h(spec: StackSpec):
    return spec.reshape != "none" and spec.h_channels > 0


def init(key, spec: StackSpec, device="cpu"):
    """Block i from ``fold_in(key, i)``, h transform j from
    ``fold_in(key, 100 + j)``, as JAX keys them."""
    p = {"blocks": [macow.init_multiscale(prng.fold_in(key, i), s, device)
                    for i, s in enumerate(spec.block_specs())]}
    if _transforms_h(spec):
        p["h_transforms"] = [
            blocks.init_conv2d_block(prng.fold_in(key, 100 + j), spec.h_channels,
                                     spec.h_channels, 3, norm="group",
                                     transposed=spec.reshape == "up", device=device)
            for j in range(len(spec.levels) - spec.reshape_step)]
    return p


def _h_transform(p_t, h, spec: StackSpec):
    if spec.reshape == "down":
        return blocks.conv2d_block_apply(p_t, h, stride=2, padding=1, norm="group", act="elu")
    return blocks.convT2d_block_apply(p_t, h, stride=2, padding=1, norm="group", act="elu")


def _block_h(p, h, i, spec: StackSpec):
    if _transforms_h(spec) and i >= spec.reshape_step:
        return _h_transform(p["h_transforms"][i - spec.reshape_step], h, spec)
    return h


def forward(p, x, h, spec: StackSpec):
    ld = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    out = x
    for i, (block, bs) in enumerate(zip(p["blocks"], spec.block_specs())):
        if spec.reshape != "none" and i == spec.reshape_step:
            out = space_to_depth(out) if spec.reshape == "down" else depth_to_space(out)
        out, l = macow.multiscale_forward(block, out, _block_h(p, h, i, spec), bs)
        ld = ld + l
    return out, ld


def inverse(p, y, h, spec: StackSpec):
    specs = spec.block_specs()
    out = y
    for i in reversed(range(len(specs))):
        out = macow.multiscale_inverse(p["blocks"][i], out, _block_h(p, h, i, spec), specs[i])
        if spec.reshape != "none" and i == spec.reshape_step:
            out = depth_to_space(out) if spec.reshape == "down" else space_to_depth(out)
    return out
