"""Top-level flow wrappers (counterpart of ``ipoke_tpu/flows/transformer.py``):
config dict -> FlowSpec (or StackSpec for ``multistack`` configs),
``init(key, spec)``, ``forward(params, spec, x, cond) -> (z, logdet)`` and
``reverse(params, spec, z, cond) -> x``.
"""
from __future__ import annotations

from ipoke_tpu_torch.flows import macow, multistack
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.flows.multistack import StackSpec
from ipoke_tpu_torch.utils import profiling


def spec_from_config(arch: dict, mcf_backend: str = "scan") -> FlowSpec:
    """FlowSpec from the reference's ``architecture:`` section with the derived
    fields flow_in_channels, flow_mid_channels and h_channels filled in.  As
    in JAX, no config key sets ``cond_conv``."""
    return FlowSpec(
        num_steps=tuple(arch["num_steps"]),
        in_channels=int(arch["flow_in_channels"]),
        hidden_channels=int(arch["flow_mid_channels"]),
        h_channels=int(arch.get("h_channels", 0)),
        factor=int(arch.get("factor", 16)),
        transform=arch.get("transform", "affine"),
        prior_transform=arch.get("prior_transform", "affine"),
        alpha=float(arch.get("alpha", 1.0)),
        kernel_size=tuple(arch.get("kernel_size", (2, 3))),
        activation=arch.get("activation", "elu"),
        use_1x1=bool(arch.get("use1x1", False)),
        condition_nice=bool(arch.get("condition_nice", False)),
        attention=bool(arch.get("attention", False)),
        heads=int(arch.get("flow_attn_heads", 4)),
        spatial_size=int(arch.get("ssize", 8) or 8),
        mcf_backend=mcf_backend,
    )


def stack_spec_from_config(arch: dict, mcf_backend: str = "scan") -> StackSpec:
    """StackSpec of a ``multistack`` config (the reference's
    MacowTransformerMultiStep); it carries no ``attention`` or ``cond_conv``."""
    return StackSpec(
        levels=tuple(tuple(level) for level in arch["levels"]),
        factors=tuple(arch["factors"]),
        in_channels=int(arch["flow_in_channels"]),
        mid_channels_factor=int(arch["flow_mid_channels_factor"]),
        h_channels=int(arch.get("h_channels", 0)),
        reshape=arch.get("reshape", "none"),
        transform=arch.get("transform", "affine"),
        prior_transform=arch.get("prior_transform", "affine"),
        kernel_size=tuple(arch.get("kernel_size", (2, 3))),
        activation=arch.get("activation", "elu"),
        use_1x1=bool(arch.get("use1x1", False)),
        condition_nice=bool(arch.get("condition_nice", False)),
        mcf_backend=mcf_backend,
    )


def is_stack(spec) -> bool:
    return isinstance(spec, StackSpec)


def init(key, spec, device="cpu"):
    if is_stack(spec):
        return multistack.init(key, spec, device)
    return macow.init_multiscale(key, spec, device)


def forward(params, spec, x, cond):
    """Density direction: data -> gaussian.  x: (B,s,s,C), cond: (B,s,s,Hc)."""
    if is_stack(spec):
        return multistack.forward(params, x, cond, spec)
    return macow.multiscale_forward(params, x, cond, spec)


def reverse(params, spec, z, cond):
    with profiling.span("flow.reverse"):
        if is_stack(spec):
            return multistack.inverse(params, z, cond, spec)
        return macow.multiscale_inverse(params, z, cond, spec)


def reverse_input_shape(spec, batch: int, spatial: int, channels: int):
    """Shape of the Gaussian z the reverse pass consumes, given the motion
    latent's geometry: a stack with a reshape gaussianises at the reshaped
    geometry (x4 channels and /2 size for ``down``, the other way for ``up``)."""
    if is_stack(spec) and spec.reshape == "down":
        return (batch, spatial // 2, spatial // 2, channels * 4)
    if is_stack(spec) and spec.reshape == "up":
        return (batch, spatial * 2, spatial * 2, channels // 4)
    return (batch, spatial, spatial, channels)

