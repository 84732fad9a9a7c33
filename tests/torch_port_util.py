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


def tiny_config(base_dir, ckpts=None, seed=0, spatial=64, frames=3):
    """A config of the tiny second stage (2 flow levels of one step, hidden 32,
    towers and first stage of width 16, 8x8 latent; 64 is the least spatial
    size of an 8x8 latent), with frozen components from ``ckpts`` paths."""
    sections = {
        "first_stage": {"spec": {"z_dim": 16, "ENC_M_channels": [16, 16, 16, 16],
                                 "dec_channels": [16, 16, 16, 16], "n_gru_layers": 2,
                                 "min_spatial_size": 8, "motion_bias": True, "full_seq": True}},
        "poke_embedder": {"spec": {"nf_max": 16, "min_spatial_size": 8}},
        "conditioner": {"use": True, "spec": {"nf_max": 16, "min_spatial_size": 8}},
    }
    for k, path in (ckpts or {}).items():
        sections[k]["ckpt"] = path
    return {
        "general": {"experiment": "serve_ckpt", "base_dir": str(base_dir), "seed": seed},
        **sections,
        "data": {"spatial_size": [spatial, spatial], "max_frames": frames},
        "architecture": {"flow_mid_channels_factor": 2, "kernel_size": [2, 3], "num_steps": [1, 1],
                         "factor": 16, "activation": "elu", "transform": "affine",
                         "prior_transform": "affine", "condition_nice": False,
                         "augmented_input": False, "multistack": False},
    }


def flatten(tree, prefix=""):
    """A nested dict/list tree as {'a/0/b': leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def clone_tree(tree):
    """A copy of a tree of tensors, in its own key order."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def t(a):
    """numpy -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def hwio_to_oihw(w):
    return t(np.asarray(w).transpose(3, 2, 0, 1))
