"""Process groups and the port's collectives (counterpart of
``ipoke_tpu/parallel/distributed.py``).

The JAX package starts ``jax.distributed`` from the TPU pod's environment;
the port starts ``torch.distributed`` from torchrun's (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit arguments.  One
process is one place on the mesh (``parallel/mesh.py``).  A single process
without those variables runs alone, and every call here is a no-op there.

    from ipoke_tpu_torch.parallel import distributed, mesh as pmesh
    distributed.maybe_initialize()               # idempotent, env-driven
    m = pmesh.make_mesh(n_data, n_model, "cuda")
    batch = distributed.host_local_batch(local_batch, m)

The collectives below are the only ones the port's parallel code calls.  They
use ``all_reduce``, ``all_gather`` and ``broadcast``: gloo carries all three
on CUDA tensors as well as NCCL does, so one code path serves two ranks on one
card (gloo) and one rank per card (NCCL).  A reduce-scatter is an all-reduce
followed by a slice; a halo exchange is an all-gather of each shard's edge
frames.  Nothing here moves a tensor to another device or falls back to
another backend: a backend that lacks a collective raises.

The differentiable ones are ``torch.autograd.Function``s whose backward is
their forward's transpose:

* ``all_reduce``: a sum consumed by every rank's own computation; its
  transpose sums the ranks' cotangents again;
* ``copy_to`` (identity forward, sum backward) and ``reduce_from`` (sum
  forward, identity backward): the two ends of a tensor-parallel region,
  where the computation before ``copy_to`` and after ``reduce_from`` is the
  same on every rank of the group;
* ``halo``: each shard's neighbours' edge frames; its transpose sends the
  gradient of a received frame back to the shard that owns it.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def is_multi_host_env() -> bool:
    """True when torchrun's coordinates name more than one process
    (``WORLD_SIZE`` > 1) or a rendezvous address is given (``MASTER_ADDR``)."""
    if os.environ.get("MASTER_ADDR"):
        return True
    return int(os.environ.get("WORLD_SIZE") or 1) > 1


def default_backend(device, local_ranks=None) -> str:
    """``'nccl'`` when every process of this host has a card of its own,
    else ``'gloo'`` (the CPU, or several ranks on one card, which NCCL
    refuses as "Duplicate GPU detected").  ``local_ranks``: the processes on
    this host (torchrun's ``LOCAL_WORLD_SIZE`` when None)."""
    device = torch.device(device)
    local = local_ranks or int(os.environ.get("LOCAL_WORLD_SIZE")
                               or os.environ.get("WORLD_SIZE") or 1)
    if device.type == "cuda" and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def maybe_initialize(init_method=None, world_size=None, rank=None, backend=None,
                     device="cpu", timeout=None) -> bool:
    """Start the default process group when the environment (or
    ``init_method``) names more than one process; a no-op otherwise.
    Returns True when the process runs in a group of more than one.
    Idempotent.  ``backend``: ``'gloo'`` or ``'nccl'``; by default
    :func:`default_backend` of ``device``.  ``timeout``: how long a
    collective may wait (a ``datetime.timedelta``; torch's default when
    None)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and not is_multi_host_env():
        return False
    backend = backend or default_backend(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the port runs on 'gloo' or 'nccl'")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE") or 1)
    if rank is None:
        rank = int(os.environ.get("RANK") or 0)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return True


def process_info():
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1}
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size()}


def host_local_batch(local_batch, mesh):
    """This process's rows of the global batch as tensors (the port's
    counterpart of ``jax.make_array_from_process_local_data``: each process
    feeds its own rows, and the global batch is their concatenation in the
    order of the ``data`` axis).  Raises unless every process of the mesh
    gives as many rows."""
    from ipoke_tpu_torch.parallel.mesh import group

    out = {k: torch.as_tensor(v) for k, v in local_batch.items()}
    rows = {int(t.shape[0]) for t in out.values()}
    if len(rows) != 1:
        raise ValueError(f"the batch's leaves disagree on their rows: {sorted(rows)}")
    if dist.is_initialized():
        b, g = rows.pop(), group(mesh, "data")
        n = torch.tensor([b, -b], dtype=torch.int64, device=comm_device(g))  # max, -min
        dist.all_reduce(n, op=dist.ReduceOp.MAX, group=g)
        if int(n[0]) != -int(n[1]):
            raise ValueError(f"the processes feed between {-int(n[1])} and {int(n[0])} rows")
    return out


def barrier(name: str = "ipoke"):
    """A barrier of every process (checkpoint writes, eval fan-in).  A no-op
    in one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def comm_device(group=None) -> torch.device:
    """Where a small tensor of bookkeeping must lie for ``group``'s backend:
    NCCL takes CUDA tensors only."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_size(group) -> int:
    return dist.get_world_size(group)


def sum_(x, group):
    """The sum over ``group`` of ``x``, a new tensor (no autograd)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if group_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y


def gather(x, group):
    """Every rank's ``x`` (same shape on all), in group order (no autograd)."""
    x = x.detach().contiguous()
    if group_size(group) == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def gather_cat(x, dim, group):
    """The group's ``x`` concatenated along ``dim`` in group order."""
    if group_size(group) == 1:
        return x.detach()
    return torch.cat(gather(x, group), dim=dim)


def chunk(x, dim, group):
    """This rank's chunk of ``x`` along ``dim`` (a view): the inverse of
    :func:`gather_cat`."""
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * k, k)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x, group):
    """Differentiable sum over ``group``, each rank consuming the sum with
    its own computation: the backward sums the cotangents again."""
    return _AllReduce.apply(x, group)


def copy_to(x, group):
    """Enter a tensor-parallel region: identity forward, sum backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Leave a tensor-parallel region: sum forward, identity backward."""
    return _ReduceFrom.apply(x, group)


class _Halo(torch.autograd.Function):
    """edges (B, 2, ...) = [first frame, last frame] of each shard ->
    (left, right): the last frame of the shard before and the first frame of
    the shard after, zeros at the ends of the sequence."""

    @staticmethod
    def forward(ctx, edges, group):
        ctx.group = group
        r, n = group_rank(group), group_size(group)
        got = gather(edges, group)
        left = got[r - 1][:, 1:2] if r > 0 else torch.zeros_like(edges[:, :1])
        right = got[r + 1][:, 0:1] if r < n - 1 else torch.zeros_like(edges[:, :1])
        return left, right

    @staticmethod
    def backward(ctx, g_left, g_right):
        r, n = group_rank(ctx.group), group_size(ctx.group)
        got = gather(torch.cat([g_left, g_right], dim=1), ctx.group)
        zero = torch.zeros_like(g_left)
        first = got[r - 1][:, 1:2] if r > 0 else zero     # my first frame was r-1's right halo
        last = got[r + 1][:, 0:1] if r < n - 1 else zero  # my last frame was r+1's left halo
        return torch.cat([first, last], dim=1), None


def halo(x, group):
    """(left, right) halo frames of the time axis (dim 1) of ``x``: the
    neighbouring shards' edge frames, zeros beyond the sequence's ends."""
    return _Halo.apply(torch.cat([x[:, :1], x[:, -1:]], dim=1), group)
