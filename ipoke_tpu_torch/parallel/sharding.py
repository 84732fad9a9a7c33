"""Parameter sharding rules (counterpart of ``ipoke_tpu/parallel/sharding.py``).

Each rule returns a tree shaped like the port's trainable params with, at
every tensor, its placement (``parallel/mesh.Split`` or ``None``): which mesh
axis it splits over, and along which of the port's dims.

The rules decide on JAX's shapes, so that they split the same leaves along
the same logical axis as JAX's rules do on the same model:

* JAX's conv kernels are HWIO (3D: DHWIO), the port's OIHW (OIDHW); a
  growing size adapter's transpose-conv kernel is ``(in, out, kh, kw)``
  here.  The rules read the JAX shape and translate the axis they pick.
* JAX stacks a level's MaCowSteps on a leading axis, the port keeps a list
  (``ckpt/jax_bridge``).  A step's leaf is decided on its stacked shape: the
  size threshold counts every step, and a 4-D leaf of a step is 5-D for
  JAX's tensor-parallel rule, which therefore leaves it replicated.  Under
  JAX only the priors' NICE couplings split over ``model``.  A rule that
  would split the step axis itself raises: the port has no such placement.
* ``max(cands, key=...)`` takes the first of equally large axes in JAX's
  order, and so does the port.

``mesh`` is a ``DeviceMesh`` or a mapping of axis names to sizes: the rules
read only the sizes.
"""
from __future__ import annotations

import math

from ipoke_tpu_torch.parallel.mesh import Split, axis_size

# the port layout of a JAX kernel: port dim k holds JAX axis perm[k] (nn/core.from_hwio)
_HWIO_TO_OIHW = (3, 2, 0, 1)
_HWIO_TO_IOHW = (2, 3, 0, 1)     # a transpose conv's (in, out, kh, kw)
_DHWIO_TO_OIDHW = (4, 3, 0, 1, 2)
_KERNELS = ("w", "v")


def _walk(tree, fn, transposed=(), path=(), n_steps=0):
    """``tree`` with every tensor ``t`` at ``path`` replaced by ``fn(path,
    jax_shape, jax_to_port, t)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, transposed, path + (k,), n_steps) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        steps = len(tree) if path and path[-1] == "steps" else n_steps
        return type(tree)(_walk(v, fn, transposed, path + (str(i),), steps)
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    is_transposed = bool(path) and path[0] in transposed
    shape, dims = _leaf_layout(path, tree, is_transposed, n_steps)
    return fn(path, shape, dims, tree)


def _leaf_layout(path, t, transposed, n_steps):
    shape = tuple(t.shape)
    dims = tuple(range(len(shape)))
    if path[-1] in _KERNELS and t.dim() in (4, 5):
        perm = _DHWIO_TO_OIDHW if t.dim() == 5 else (
            _HWIO_TO_IOHW if transposed else _HWIO_TO_OIHW)
        jax_shape, to_port = [0] * len(perm), [0] * len(perm)
        for port_dim, jax_axis in enumerate(perm):
            jax_shape[jax_axis] = shape[port_dim]
            to_port[jax_axis] = port_dim
        shape, dims = tuple(jax_shape), tuple(to_port)
    if n_steps:
        return (n_steps,) + shape, (None,) + dims
    return shape, dims


def _split(axis, jax_axis, dims, path):
    dim = dims[jax_axis]
    if dim is None:
        raise ValueError(f"{'/'.join(path)}: the rule splits JAX's stacked step axis, which "
                         "the port keeps as a list")
    return Split(axis, dim)


def flow_param_shardings(mesh, params, min_width: int = 256, transposed=()):
    """Tensor parallelism over ``model``: JAX's rule for the NICE convs
    (conv1's ``w`` along its output channels, conv2's along its input
    channels, conv3's weight-norm ``v`` along its input channels), on 4-D
    JAX kernels only, every other leaf replicated.  ``transposed``: the
    top-level names whose kernels are transpose convs (the growing size
    adapters, ``ckpt/jax_bridge.grown_adapters``)."""
    def leaf(path, shape, dims, t):
        if len(path) >= 2 and path[-1] == "w" and path[-2] in ("conv1", "conv2"):
            if len(shape) == 4 and shape[-1] >= min_width:
                if path[-2] == "conv2" and shape[-2] >= min_width:
                    return _split("model", 2, dims, path)
                return _split("model", 3, dims, path)
        if len(path) >= 2 and path[-1] == "v" and path[-2] == "conv3":
            if len(shape) == 4 and shape[-2] >= min_width:
                return _split("model", 2, dims, path)
        return None

    return _walk(params, leaf, transposed)


def _largest_axis_leaf_sharding(mesh, axis_name: str, min_size: int):
    """The leaf rule shared by ZeRO-1 (moments) and FSDP (params): split a
    tensor along its largest JAX axis divisible by the mesh axis; tiny
    leaves stay replicated."""
    n = axis_size(mesh, axis_name)

    def leaf(path, shape, dims, t):
        if not shape or math.prod(shape) < min_size:
            return None
        cands = [i for i, d in enumerate(shape) if d % n == 0 and d >= n]
        if not cands:
            return None
        return _split(axis_name, max(cands, key=lambda i: shape[i]), dims, path)

    return leaf


def fsdp_param_shardings(mesh, params, min_size: int = 8192, tp_shardings=None, transposed=()):
    """FSDP: every large parameter leaf split over ``data``; a leaf that
    ``tp_shardings`` places keeps that placement."""
    fsdp = _walk(params, _largest_axis_leaf_sharding(mesh, "data", min_size), transposed)
    if tp_shardings is None:
        return fsdp
    return _zip(lambda tp, fs: fs if tp is None else tp, tp_shardings, fsdp)


def zero_opt_state_shardings(mesh, params, min_size: int = 8192, transposed=()):
    """ZeRO-1: the placement over ``data`` of the optimizer's moments (mu,
    nu, ...) of each leaf of ``params``, which have that leaf's shape; the
    steps' counts stay replicated.  JAX applies the same leaf rule to its
    optimizer state's tree, whose moments mirror the params."""
    return _walk(params, _largest_axis_leaf_sharding(mesh, "data", min_size), transposed)


def _zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def placements(tree):
    """The placements of a rule's tree, depth first in key order (the order
    of ``train/second_stage.leaves``)."""
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in placements(v)]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in placements(v)]
    return [tree]
