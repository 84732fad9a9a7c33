"""Reference-shaped second-stage trees at test size for the checkpoint
ingestion tests (``test_torch_ckpt_import``, ``test_torch_convert_all``,
``test_torch_cuda``).  Imports neither JAX nor the JAX package, so the
card's tests use it too."""
from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def redraw(tree, seed):
    """The float leaves of a JAX-layout numpy tree redrawn with numpy: unit
    ``u``, kernels ``w``/``v`` N(0, 1/fan_in), norm gains near 1,
    weight-norm gains near 0.05 and every other leaf N(0, 1e-4), so no
    coupling is the identity and a sample stays finite; integer leaves (the
    permutations) kept."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        a = np.asarray(node)
        if np.issubdtype(a.dtype, np.integer):
            return a
        x = rng.standard_normal(a.shape)
        if name == "u":
            x = x / np.linalg.norm(x)
        elif name in ("w", "v"):
            x = x / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "g":
            x = 0.05 * (1 + 0.1 * x)
        elif name == "gamma":
            x = 1 + 0.1 * x
        else:
            x = 0.01 * x
        return x.astype(np.float32)

    return walk(tree)


def reference_tree(spec, seed=0):
    """A second stage of the port's spec in JAX's npz layout as a released
    checkpoint holds it: every component from the port's init (JAX's
    numbers), the towers with both halves and every spectral-norm ``u``, the
    first stage's decoder with its ``u``; then redrawn (``redraw``)."""
    from ipoke_tpu_torch.ckpt import jax_bridge
    from ipoke_tpu_torch.models import encoders, first_stage, second_stage
    from ipoke_tpu_torch.utils import prng

    ks = prng.split(prng.prng_key(seed), 4)
    tree = jax_bridge.unbridge_second_stage(
        dict(second_stage.init(ks[0], spec, CPU, only=("flow",)),
             first_stage=first_stage.init(ks[1], spec.first_stage, CPU, spectral_u=True)), spec)
    tree["poke_embedder"] = jax_bridge.unbridge_wrapper(
        encoders.init_wrapper(ks[2], spec.poke_embedder, CPU, train=True))
    if spec.use_cond:
        tree["conditioner"] = jax_bridge.unbridge_wrapper(
            encoders.init_wrapper(ks[3], spec.conditioner, CPU, train=True))
    return redraw(tree, seed)
