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
    kw = _fields(jspec, drop=("remat", "mcf_backend", "mcf_unroll"))
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


# ---------------------------------------------------------------------------
# stage-1 GAN training at test size
# ---------------------------------------------------------------------------

# A first stage about as small as the GAN step takes (GroupNorm's 16 groups
# set the encoder's width, a 4x4 latent allows 32^2 frames), one GRU layer, a
# one-block-per-layer temporal disc on 2-frame crops, a one-layer patch disc.
GAN_FS = dict(z_dim=8, spatial_size=32, max_frames=3, enc_channels=(16, 16, 16, 16),
              dec_channels=(16, 8, 8, 8), n_gru_layers=1, min_spatial_size=4, motion_bias=True,
              full_sequence=True)
GAN_DS = dict(n_layers=1)
GAN_DT = dict(spatial_size=32, sequence_length=2, layers=(1, 1, 1, 1))
GAN_BATCH = 2


def gan_specs(fs_mod, d_mod, **dt_overrides):
    """(FirstStageSpec, PatchDiscSpec, TempDiscSpec) of the test size from a
    package's ``models.first_stage`` and ``models.discriminators``."""
    return (fs_mod.FirstStageSpec(**GAN_FS), d_mod.PatchDiscSpec(**GAN_DS),
            d_mod.TempDiscSpec(**dict(GAN_DT, **dt_overrides)))


def random_like(shapes, seed):
    """A JAX-layout param tree of the shapes of ``shapes`` (a tree of arrays
    or ShapeDtypeStructs) drawn with numpy: kernels N(0, 1/fan_in), norm
    gains 1 + N(0, 0.01), other vectors N(0, 0.01), unit ``u`` vectors."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        shape = tuple(node.shape)
        x = rng.standard_normal(shape)
        if name == "u":
            x = x / np.linalg.norm(x)
        elif len(shape) >= 2 and name != "motion_bias":
            x = x / np.sqrt(np.prod(shape[:-1]))
        elif name == "gamma":
            x = 1 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return walk(shapes)


def assert_trees_equal(a, b, path=""):
    """Same keys, same list lengths, every leaf of the same dtype and bitwise
    equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), path
