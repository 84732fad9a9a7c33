"""Shared helpers of the ``test_torch_*`` files: the same seeded numpy inputs
go through the JAX package and through the PyTorch port on the CPU."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ipoke_tpu_torch.flows.macow import FlowSpec as PortFlowSpec
from ipoke_tpu_torch.models.encoders import WrapperSpec as PortWrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec as PortFirstStageSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec as PortSecondStageSpec

CPU = torch.device("cpu")

# The port's CPU path is many tiny ops; intra-op threads only add overhead
# there, and the suite runs several workers side by side.
torch.set_num_threads(1)


def np_tree(tree):
    """A JAX param tree as numpy arrays (the bridge's input)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def set_wn_gains(tree, g):
    """Every weight-norm node's gain set to ``g``, so no coupling is the identity."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            return dict(tree, g=g * jnp.ones_like(tree["g"]))
        return {k: set_wn_gains(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [set_wn_gains(v, g) for v in tree]
    return tree


def _fields(spec, drop=()):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec) if f.name not in drop}


def port_flow_spec(jspec, **overrides):
    kw = _fields(jspec, drop=("heads", "spatial_size", "remat", "mcf_backend", "mcf_unroll"))
    kw.update(overrides)
    return PortFlowSpec(**kw)


def port_second_stage_spec(jspec, **flow_overrides):
    kw = _fields(jspec)
    kw["flow"] = port_flow_spec(jspec.flow, **flow_overrides)
    kw["first_stage"] = PortFirstStageSpec(**_fields(jspec.first_stage))
    kw["poke_embedder"] = PortWrapperSpec(**_fields(jspec.poke_embedder))
    kw["conditioner"] = (None if jspec.conditioner is None
                         else PortWrapperSpec(**_fields(jspec.conditioner)))
    return PortSecondStageSpec(**kw)


def t(a):
    """numpy -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def hwio_to_oihw(w):
    return t(np.asarray(w).transpose(3, 2, 0, 1))
