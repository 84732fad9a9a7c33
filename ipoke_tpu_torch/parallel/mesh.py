"""The device mesh and batch placement (counterpart of
``ipoke_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``("data", "model")`` mesh and lets
GSPMD place arrays on it.  The port runs one process per place on the mesh
(``parallel/distributed.py``): a ``torch.distributed`` ``DeviceMesh`` over
all ranks, row-major, so rank ``r`` sits at ``data = r // n_model``, ``model
= r % n_model``, as JAX's ``np.reshape`` of its device list puts device r.
Each process holds only what it computes on: its rows of the batch, and its
shards of what the rules of ``parallel/sharding.py`` split.

A placement is ``None`` (replicated: every rank holds all of it) or a
:class:`Split` (``axis`` of the mesh, ``dim`` of the port's tensor): the rank
holds chunk ``i`` of ``n`` along ``dim``, ``i`` its index on ``axis``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Split:
    axis: str
    dim: int


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cpu",
              names=("data", "model")):
    """A ``DeviceMesh`` of ``n_data x n_model`` ranks named ``names``, over
    every rank of the default process group (``n_data`` defaults to the
    world size over ``n_model``).  ``device_type``: ``'cuda'`` or ``'cpu'``,
    where the ranks' tensors lie."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} needs {n_data * n_model} processes, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=tuple(names))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``: 1 for an axis the mesh lacks.  ``mesh`` is a
    ``DeviceMesh`` or a mapping of axis names to sizes (what the rules of
    ``parallel/sharding.py`` read)."""
    if isinstance(mesh, dict):
        return int(mesh.get(axis, 1))
    names = mesh.mesh_dim_names
    return int(mesh.size(names.index(axis))) if axis in names else 1


def mesh_shape(mesh) -> dict:
    """``{axis name: size}``, as JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def axis_index(mesh, axis: str) -> int:
    """This rank's index on ``axis`` (0 for an axis the mesh lacks)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def group(mesh, axis: str):
    """The process group of the ranks that share every coordinate but
    ``axis``'s."""
    return mesh.get_group(axis)


def shard_batch(mesh, batch):
    """This rank's rows of every leaf of the global ``batch`` (a dict or list
    tree of arrays or tensors): rank ``i`` on ``data`` holds rows ``i B/n ..
    (i+1) B/n``, as JAX's ``P("data")`` places them."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over data={n}")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return rows(batch)


def replicate(mesh, tree):
    """Every tensor of ``tree`` made rank 0's, in place (a broadcast over the
    whole mesh); returns ``tree``."""
    for t in _tensors(tree):
        dist.broadcast(t.data, src=0)
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []

