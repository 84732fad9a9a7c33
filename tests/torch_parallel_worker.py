"""Gloo worlds of processes for the port's parallel tests (on the CPU, or
all on a card).

``World(n, cases)`` spawns ``n`` ranks (a file rendezvous in a temporary
directory, so test workers never share a port) that run every case of
``cases`` in order; ``.result()`` returns ``{case name: [result of rank 0,
...]}``.  A rank that fails, or a world that is not done within ``timeout``
seconds, fails the call instead of hanging it.  The ranks import torch and the port
only, never JAX: the tests compare their results with JAX in their own
process.
"""
from __future__ import annotations

import datetime
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _rank(rank, n, init, cases, q, device):
    from ipoke_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    if device == "cuda":   # every rank on the one card, or one card per rank
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        distributed.maybe_initialize(init, n, rank, "gloo", device,
                                     timeout=datetime.timedelta(seconds=100))
        for name, fn, kw in cases:
            out[name] = _np(fn(rank, n, **kw))
        distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the test, which fails
        q.put((rank, {"error": traceback.format_exc()}))
        raise
    q.put((rank, out))


class World:
    """``n`` spawned ranks running ``cases``; ``result()`` waits for them
    (several worlds run at once: start them all, then collect).  On
    ``device`` ``'cuda'`` the ranks share the cards round robin, over gloo."""

    def __init__(self, n, cases, timeout=120.0, device="cpu"):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.cases, self.q = n, cases, ctx.Queue()
        self.tmp = tempfile.TemporaryDirectory(prefix="ipoke_world_")
        self.deadline = time.monotonic() + timeout
        self.procs = [ctx.Process(target=_rank, args=(r, n, f"file://{self.tmp.name}/rdv",
                                                      cases, self.q, device))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def result(self):
        got = {}
        try:
            while len(got) < self.n:
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"a world of {self.n} ranks ran out of time")
                try:
                    rank, res = self.q.get(timeout=1.0)
                except queue_mod.Empty:
                    if all(p.exitcode is not None for p in self.procs) and self.q.empty():
                        raise RuntimeError(
                            f"ranks exited with {[p.exitcode for p in self.procs]}") from None
                    continue
                if "error" in res:
                    raise RuntimeError(f"rank {rank} of {self.n} failed:\n{res['error']}")
                got[rank] = res
        finally:
            for p in self.procs:
                p.join(timeout=20)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            self.tmp.cleanup()
        return {name: [got[r][name] for r in range(self.n)] for name, _, _ in self.cases}


# ---------------------------------------------------------------------------
# cases: fn(rank, n, **kw) -> a picklable result
# ---------------------------------------------------------------------------

def mesh_case(rank, n):
    """Mesh shapes, this rank's coordinates, its rows of a batch, the
    process-local batch, a broadcast and the collectives' transposes."""
    from ipoke_tpu_torch.data.loader import device_prefetch
    from ipoke_tpu_torch.parallel import distributed
    from ipoke_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh()
    m2 = pmesh.make_mesh(n_data=n // 2, n_model=2)
    batch = {"x": np.arange(4 * n * 3, dtype=np.float32).reshape(4 * n, 3)}
    local = pmesh.shard_batch(m2, batch)
    placed = distributed.host_local_batch(local, m2)
    (prefetched,) = device_prefetch([batch], "cpu", mesh=m2)
    t = torch.full((3,), float(rank))
    pmesh.replicate(m2, {"a": [t]})
    # the collectives and their backward
    x = torch.tensor([float(rank + 1)], requires_grad=True)
    g = pmesh.group(m, "data")
    ar = distributed.all_reduce(x * 2, g)
    (gx_ar,) = torch.autograd.grad(ar.sum(), x)
    (gx_copy,) = torch.autograd.grad(distributed.copy_to(x, g).sum() * (rank + 1), x)
    (gx_red,) = torch.autograd.grad(distributed.reduce_from(x, g).sum() * (rank + 1), x)
    try:   # a rank whose rows differ from the others' must raise
        distributed.host_local_batch({"x": np.zeros((1 + (rank == 0), 3), np.float32)}, m)
        uneven = "no error"
    except ValueError as e:
        uneven = str(e)
    return {"shape": pmesh.mesh_shape(m), "shape2": pmesh.mesh_shape(m2),
            "coords2": (pmesh.axis_index(m2, "data"), pmesh.axis_index(m2, "model")),
            "rows": local["x"], "placed": placed["x"], "prefetched": prefetched["x"],
            "replicated": t,
            "info": distributed.process_info(), "all_reduce": ar, "grad_all_reduce": gx_ar,
            "grad_copy_to": gx_copy, "grad_reduce_from": gx_red, "uneven": uneven}


def train_case(rank, n, meshes, augment=0, **opt_kw):
    """Per mesh (n_data, n_model, options of the leg), STEPS sharded steps of
    the dry run's tiny model (with ``augment`` augment channels on the
    flow's input) against the one-process steps."""
    from dataclasses import replace

    from ipoke_tpu_torch.parallel import dryrun

    me = dryrun.Rank(rank, n, torch.device("cpu"), full=False)
    if augment:
        flow = me.train_spec.flow
        me.train_spec = replace(me.train_spec, augment_channels=augment,
                                flow=replace(flow, in_channels=flow.in_channels + augment))
    ref = dryrun.reference(me, **opt_kw)
    return [dryrun.train_leg(me, ref, d, m, **dict(kw, **opt_kw)) for d, m, kw in meshes]


def gathered_train_case(rank, n, n_microbatches=1):
    """The dry run's data-parallel + ZeRO-1 step on its tiny model with
    ``donate=False`` and ``n_microbatches``, STEPS steps: the whole
    trainable params gathered after them, the last step's metrics, and
    whether the state given stayed as it was."""
    from ipoke_tpu_torch.parallel import dryrun
    from ipoke_tpu_torch.parallel import mesh as pmesh
    from ipoke_tpu_torch.train import second_stage as train_ss

    me = dryrun.Rank(rank, n, torch.device("cpu"), full=False)
    mesh = pmesh.make_mesh(n, 1)
    state, step_fn = dryrun._setup(me, dryrun.params_for(me, 0), n_microbatches)
    start = [t.detach().clone() for t in train_ss.float_leaves(state.params)]
    placed, step = train_ss.shard_train_setup(mesh, state, step_fn, zero_opt=True, donate=False,
                                              zero_min_size=me.zero_min_size)
    batch = pmesh.shard_batch(mesh, dryrun.global_batch(me, me.batch_rows))
    for key in dryrun._keys():
        placed, metrics = step(placed, batch, key)
    kept = all(torch.equal(a, b) for a, b in zip(train_ss.float_leaves(state.params), start))
    return {"params": step.full_params(placed), "metrics": {k: float(v) for k, v in
                                                           metrics.items()}, "kept": kept}


def micro_leg_case(rank, n, n_microbatches):
    """The dry run's microbatched leg (``dryrun.micro_leg``) on its tiny
    model."""
    from ipoke_tpu_torch.parallel import dryrun

    return dryrun.micro_leg(dryrun.Rank(rank, n, torch.device("cpu"), full=False),
                            n_microbatches)


def sample_case(rank, n):
    from ipoke_tpu_torch.parallel import dryrun

    me = dryrun.Rank(rank, n, torch.device("cpu"), full=False)
    return dryrun.sample_leg(me)


# the sequence-parallel cases' encoder and video (tests/test_seqpar.py's),
# made in each rank from their seeds: a big argument of a spawned process
# would hold up its start until the child reads it
ENCODER = dict(channels=(16, 16, 16, 16), z_dim=8, spatial_size=32, max_frames=8,
               min_spatial_size=8, full_seq=True, deterministic=False)
VIDEO = (2, 64, 32, 32, 3)


def encoder_and_video():
    """(spec, params, x) of the sequence-parallel cases."""
    from ipoke_tpu_torch.models import motion_encoder
    from ipoke_tpu_torch.utils import prng

    spec = motion_encoder.MotionEncoderSpec(**ENCODER)
    params = motion_encoder.init(prng.prng_key(0), spec, device="cpu")
    x = np.random.default_rng(1).standard_normal(VIDEO).astype(np.float32)
    return spec, params, x


def seqpar_case(rank, n, n_data, n_seq, key=None, grad=False):
    """``seqpar.encode`` of this rank's block of the video; with ``grad``,
    the gradients of sum(mu^2) + sum(tanh(logvar)) over the whole batch,
    summed over ``data`` and averaged over ``seq`` (``parallel/seqpar``'s
    rule)."""
    from ipoke_tpu_torch.parallel import mesh as pmesh
    from ipoke_tpu_torch.parallel import seqpar
    from ipoke_tpu_torch.train.second_stage import float_leaves
    from ipoke_tpu_torch.utils import prng

    spec, params, x = encoder_and_video()
    m = pmesh.make_mesh(n_data, n_seq, names=("data", "seq"))
    batch_axis = "data" if n_data > 1 else None
    for t in float_leaves(params):
        t.requires_grad_(grad)
    block = seqpar.local_block(m, torch.from_numpy(x), "seq", batch_axis)
    rng = None if key is None else prng.prng_key(key)
    z, mu, logvar = seqpar.encode(params, block, spec, m, batch_axis=batch_axis, rng=rng)
    out = {"z": z, "mu": mu, "logvar": logvar, "data_index": pmesh.axis_index(m, "data")}
    if grad:
        loss = (mu ** 2).sum() + torch.tanh(logvar).sum()
        gs = [g.clone() for g in torch.autograd.grad(loss, float_leaves(params))]
        for g in gs:
            torch.distributed.all_reduce(g)
        out["grads"] = _with_leaves(params, iter(g / n_seq for g in gs))
    return out


def _with_leaves(t, leaves):
    if isinstance(t, dict):
        return {k: _with_leaves(v, leaves) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_with_leaves(v, leaves) for v in t]
    return next(leaves)
