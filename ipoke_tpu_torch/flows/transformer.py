"""Top-level flow wrappers (counterpart of ``ipoke_tpu/flows/transformer.py``):
config dict -> FlowSpec, ``forward(params, spec, x, cond) -> (z, logdet)`` and
``reverse(params, spec, z, cond) -> x``.  The multistack flow waits in
ROADMAP queue 1.
"""
from __future__ import annotations

from ipoke_tpu_torch.flows import macow
from ipoke_tpu_torch.flows.macow import FlowSpec


def spec_from_config(arch: dict, mcf_backend: str = "scan") -> FlowSpec:
    """FlowSpec from the reference's ``architecture:`` section with the derived
    fields flow_in_channels, flow_mid_channels and h_channels filled in."""
    if arch.get("multistack"):
        raise NotImplementedError("multistack flows are not ported yet (ROADMAP.md queue 1)")
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
        mcf_backend=mcf_backend,
    )


def forward(params, spec: FlowSpec, x, cond):
    """Density direction: data -> gaussian.  x: (B,s,s,C), cond: (B,s,s,Hc)."""
    return macow.multiscale_forward(params, x, cond, spec)


def reverse(params, spec: FlowSpec, z, cond):
    return macow.multiscale_inverse(params, z, cond, spec)


def reverse_input_shape(spec: FlowSpec, batch: int, spatial: int, channels: int):
    """Shape of the Gaussian z the reverse pass consumes."""
    return (batch, spatial, spatial, channels)
