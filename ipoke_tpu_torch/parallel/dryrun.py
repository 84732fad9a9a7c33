"""Dry run of the port's parallel legs, each held against the one-process run.

    python -m ipoke_tpu_torch.parallel.dryrun --nproc N [--device cpu|cuda]
        [--backend gloo|nccl] [--full [--steps-per-level K]]

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``,
in its order, one line per leg:

1. ``ok``: a stage-2 train step on a ``data x model`` mesh (``model`` = 2 from
   4 processes, the flow's NICE convs tensor parallel) with ZeRO-1 moments;
   with ``model`` = 1 also on a ``1 x N`` mesh, tensor parallel alone;
2. ``seqpar ok``: the motion encoder on a ``data x seq`` mesh (``seq`` =
   min(4, N)), a video's time axis split (``parallel/seqpar``);
3. ``fsdp ok``: the step of 1 under FSDP, each rank's peak memory beside 1's;
4. ``sample ok``: ``forward_sample`` on the ``data x model`` mesh, each rank
   its rows, with z fixed and with z drawn.

``run(..., n_microbatches=n)`` with n > 1 adds ``micro ok`` after 3: the
step of 1 made with n microbatches, against its own one-process run (a
caller's option, not a flag: JAX's dry run has no such leg).

Each train leg takes two steps from the same params on a global batch of
``2 x data`` (``--full``: 8) rows, then each rank's pieces are held against
the one-process steps on the global batch, which each rank runs first (all
at once, before the legs), on four readings (``TRAIN_TOLS``): the params,
their change over the two steps, their first moments and the metrics.  Adam
moves an element by about the lr whatever its gradient, so the params alone
cannot tell a wrong step from a right one; the change and the first moments,
each relative to its own norm per leaf, can.  The encoder and the videos are
held against the dense run on each rank.  The model is JAX's dry-run model (``_tiny_specs``) or,
with ``--full``, the registry flagship at full width and depth, params
synthesised from a seed with the flow's output-conv gains at ``GAIN`` (with
a fresh init's zero gains most gradients vanish).  ``--steps-per-level K``
cuts the train legs' flow (and their one-process runs) to at most K
MaCowSteps per level, every level kept; the sampler keeps the full depth.

It spawns its ranks (``--nproc``, a file rendezvous in a temporary
directory) or, under torchrun, runs as the rank torchrun made.  On CUDA each
rank takes card ``rank % device_count``: two ranks on one card need
``--backend gloo`` (NCCL refuses them).  The backend carries ``all_reduce``,
``all_gather`` and ``broadcast`` on the ranks' tensors, or the run fails:
each rank first times them (the probe).
"""
from __future__ import annotations

import argparse
import datetime
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback
from dataclasses import replace

import torch
import torch.distributed as dist

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.models import motion_encoder, second_stage
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.models.motion_encoder import MotionEncoderSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec
from ipoke_tpu_torch.ops.cuda import launches_since
from ipoke_tpu_torch.parallel import distributed, seqpar
from ipoke_tpu_torch.parallel import mesh as pmesh
from ipoke_tpu_torch.parallel import sharding as psh
from ipoke_tpu_torch.serve.batcher import CUDA_BATCH_TOL
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng, profiling, synth

GAIN = 0.02           # the flow's output-conv gains (utils/synth.set_flow_output_gains)
STEPS = 2             # train steps per leg
# Adam moves every param by ~LR a step whatever its gradient, and a gradient
# element within rounding of zero flips its move between two summation orders:
# LR keeps such a flip inside the params' tolerance
LR = 1e-4
# a train leg's readings after STEPS steps, each rank on its pieces, per device type:
#   params   max|p - p_ref| / (1 + max|p_ref|), over the leaves (JAX's test; 2e-5 is JAX's)
#   update   max over the leaves of ||dp - dp_ref|| / ||dp_ref||, dp = p - p at the start
#   mu       max over the leaves of ||mu - mu_ref|| / ||mu_ref||, the first moments
#   metrics  max over the metrics of |m - m_ref| / |m_ref|
# update carries the few elements whose move flips between summation orders; on the card
# the f32 sums run in other orders than on the CPU (cuDNN picks algorithms per batch size)
TRAIN_TOLS = {"cpu": {"params": 2e-5, "update": 1e-2, "mu": 1e-4, "metrics": 2e-5},
              "cuda": {"params": 1e-3, "update": 0.05, "mu": 1e-2, "metrics": 1e-3}}
SEQ_TOL = 1e-3        # mu of the sharded encoder against the dense one (JAX's dry run)
SAMPLE_TOL = 1e-4     # the sharded videos against the one-process videos (JAX's dry run)
# (on a card: CUDA_BATCH_TOL, as cuDNN picks its algorithms per batch size)
FULL_BATCH = 8
COLLECTIVE_TIMEOUT_S = 600


def tiny_spec() -> SecondStageSpec:
    """JAX's ``__graft_entry__._tiny_specs(full_flow=False)``."""
    fs = FirstStageSpec(z_dim=16, spatial_size=64, max_frames=4, enc_channels=(16, 16, 16, 16),
                        dec_channels=(16, 16, 16, 16), n_gru_layers=2, min_spatial_size=8,
                        motion_bias=True, full_sequence=True)
    poke = WrapperSpec(nf_in=2, nf_max=16, spatial_size=64, min_spatial_size=8, deterministic=True)
    cond = WrapperSpec(nf_in=3, nf_max=16, spatial_size=64, min_spatial_size=8,
                       deterministic=False)
    flow = FlowSpec(num_steps=(1, 1), in_channels=16, hidden_channels=32, h_channels=32,
                    factor=16, mcf_backend="cuda_unit")
    return SecondStageSpec(flow=flow, first_stage=fs, poke_embedder=poke, conditioner=cond)


# JAX's _dryrun_seqpar encoder; --full takes the flagship's own
TINY_ENCODER = MotionEncoderSpec(channels=(16, 16, 16, 16), z_dim=8, spatial_size=32,
                                 max_frames=8, min_spatial_size=8, full_seq=True,
                                 deterministic=True)


class Rank:
    """This rank's part of the dry run: its settings and its report."""

    def __init__(self, rank, world, device, full, steps_per_level=None):
        self.rank, self.world, self.device, self.full = rank, world, device, full
        self.n_model = 2 if world >= 4 else 1
        self.n_data = world // self.n_model
        if full:
            spec = registry.build_specs(registry.MODELS[registry.FLAGSHIP])
            self.spec = replace(spec, first_stage=replace(spec.first_stage,
                                                          decode_dtype="bf16")).validate()
            self.batch_rows = FULL_BATCH
            self.min_width, self.zero_min_size = 256, 8192
        else:
            self.spec = tiny_spec()
            self.batch_rows = 2 * self.n_data
            self.min_width, self.zero_min_size = 32, 512   # JAX's dry run, so tiny leaves split
        # the train legs' model: the flow on at most steps_per_level MaCowSteps per level
        self.train_spec = self.spec if steps_per_level is None else replace(
            self.spec, flow=replace(self.spec.flow, num_steps=tuple(
                min(steps_per_level, n) for n in self.spec.flow.num_steps)))
        self.train_tols = TRAIN_TOLS[device.type]
        self.sample_tol = SAMPLE_TOL if device.type == "cpu" else CUDA_BATCH_TOL
        self.report = {"rank": rank, "device": str(device)}

    def say(self, line):
        if self.rank == 0:
            print(f"dryrun({self.world}): {line}", flush=True)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_reset(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_gib(self):
        if self.device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.device) / 2**30

    def gathered(self, obj):
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def params_for(me, seed, spec=None):
    """Params of ``spec`` (the train legs' by default) from ``seed``."""
    params = synth.synth_params(spec or me.train_spec, seed=seed, device=me.device)
    return dict(params, flow=synth.set_flow_output_gains(params["flow"], GAIN))


def global_batch(me, rows):
    s, t = me.spec.first_stage.spatial_size, me.spec.first_stage.max_frames
    return {"images": prng.normal(prng.prng_key(5), (rows, t, s, s, 3), me.device),
            "poke": prng.normal(prng.prng_key(6), (rows, s, s, 2), me.device)}


def _setup(me, params, n_microbatches=1, **opt_kw):
    trainable, frozen = train_ss.split_params(params)
    opt = train_ss.make_optimizer(**dict(dict(lr=LR, warmup_steps=0, total_steps=100), **opt_kw))
    state = train_ss.init_state(trainable, opt)
    return state, train_ss.make_train_step(me.train_spec, frozen, opt,
                                           n_microbatches=n_microbatches)


def _keys():
    return [prng.fold_in(prng.prng_key(1), i) for i in range(STEPS)]


def _first_moments(opt_state):
    return next(s["mu"] for s in opt_state if "mu" in s)


def _start_params(me):
    """The float leaves every run starts from."""
    return train_ss.float_leaves(train_ss.split_params(params_for(me, 0))[0])


def reference(me, n_microbatches=1, **opt_kw):
    """The one-process run of STEPS steps on the global batch: (the float
    params' change over the steps, their first moments, both on the host;
    metrics of the last step).  ``opt_kw``: more arguments of
    ``make_optimizer``; ``n_microbatches``: ``make_train_step``'s."""
    state, step = _setup(me, params_for(me, 0), n_microbatches, **opt_kw)
    start = [t.detach().to("cpu", copy=True) for t in train_ss.float_leaves(state.params)]
    batch = global_batch(me, me.batch_rows)
    for key in _keys():
        state, metrics = step(state, batch, key)
    out = ([t.detach().cpu() - t0 for t, t0 in zip(train_ss.float_leaves(state.params), start)],
           [t.cpu() for t in _first_moments(state.opt_state)],
           {k: float(v) for k, v in metrics.items()})
    del state, step, batch, start
    return out


def _max_err(got, want):
    """max|got - want| / (1 + max|want|)."""
    return ((got.detach() - want).abs().max() / (1 + want.abs().max())).item()


def _norm_err(got, want):
    """||got - want|| / ||want||: 0 where both are 0, inf where only want is."""
    diff = (got.detach() - want).norm().item()
    ref = want.norm().item()
    return diff / ref if ref > 0 else (0.0 if diff == 0 else float("inf"))


def train_leg(me, ref, n_data, n_model, fsdp=False, zero_opt=True, tp=True, donate=True,
              n_microbatches=1, **opt_kw):
    """STEPS sharded steps, held against this rank's ``reference`` (made with
    the same ``n_microbatches`` and ``opt_kw``); returns this rank's report
    of the leg."""
    mesh = pmesh.make_mesh(n_data, n_model, me.device.type)
    me.peak_reset()
    state, step_fn = _setup(me, params_for(me, 0), n_microbatches, **opt_kw)
    tp = psh.flow_param_shardings(mesh, state.params, min_width=me.min_width) if tp else None
    placed, step = train_ss.shard_train_setup(mesh, state, step_fn, param_shardings=tp,
                                              zero_opt=zero_opt,
                                              zero_min_size=me.zero_min_size,
                                              donate=donate, fsdp=fsdp)
    del state
    batch = pmesh.shard_batch(mesh, global_batch(me, me.batch_rows))
    ms = []
    before = profiling.counts()
    for key in _keys():
        me.sync()
        t0 = time.perf_counter()
        placed, metrics = step(placed, batch, key)
        me.sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launches_since(before)
    peak = me.peak_gib()
    # this rank's pieces against the same pieces of the one-process run
    errs = {"params": 0.0, "update": 0.0, "mu": 0.0}
    for i, (t, m, t0) in enumerate(zip(train_ss.float_leaves(placed.params),
                                       _first_moments(placed.opt_state), _start_params(me))):
        t0 = step.local_view(i, t0)
        d_ref = step.local_view(i, ref[0][i].to(me.device))
        errs["params"] = max(errs["params"], _max_err(t, t0 + d_ref))
        errs["update"] = max(errs["update"], _norm_err(t - t0, d_ref))
        errs["mu"] = max(errs["mu"], _norm_err(
            m, step.local_view(i, ref[1][i].to(me.device), moment=True)))
    errs["metrics"] = max(abs(float(metrics[k]) - v) / abs(v) if v else abs(float(metrics[k]))
                          for k, v in ref[2].items())
    counts = {
        "tp_sharded_params": sum(p.store is not None and p.store.axis == "model"
                                 for p in step.plans),
        "fsdp_sharded_params": sum(p.store is not None and p.store.axis == "data"
                                   for p in step.plans),
        "zero_sharded_moments": sum(p.zero is not None for p in step.plans),
    }
    out = dict(counts, mesh={"data": n_data, "model": n_model}, fsdp=fsdp,
               n_microbatches=n_microbatches, step_ms=ms,
               peak_gib=peak, errs=errs, launches=launches,
               flow_loss=float(metrics["flow_loss"]))
    del placed, step, step_fn, batch
    return out


def micro_leg(me, n_microbatches):
    """The ``ok`` leg on the ``data x model`` mesh with a step of
    ``n_microbatches``, held against this rank's one-process run of that
    step, made here; the report gains the seconds of both (``ref_s``,
    ``leg_s``)."""
    t0 = time.perf_counter()
    ref = reference(me, n_microbatches=n_microbatches)
    ref_s = time.perf_counter() - t0
    me.peak_reset()
    t0 = time.perf_counter()
    leg = train_leg(me, ref, me.n_data, me.n_model, n_microbatches=n_microbatches)
    return dict(leg, ref_s=ref_s, leg_s=time.perf_counter() - t0)


def held(report, tols):
    """Whether a rank's train leg ``report`` is within ``tols`` (an entry of
    ``TRAIN_TOLS``)."""
    return all(report["errs"][k] <= tol for k, tol in tols.items())


def _check_train(me, what, reports):
    bad = [r for r in reports if not held(r, me.train_tols)]
    if bad:
        raise RuntimeError(f"{what}: a rank left the one-process step: {bad}")


def seqpar_leg(me):
    n_seq = min(4, me.world)
    n_data = max(1, me.world // n_seq)
    spec = me.spec.first_stage.encoder_spec if me.full else TINY_ENCODER
    params = motion_encoder.init(prng.prng_key(2), spec, device=me.device)
    t = seqpar.shortest_length(spec, n_seq) if me.full else 64
    mesh = pmesh.make_mesh(n_data, n_seq, me.device.type, names=("data", "seq"))
    x = prng.normal(prng.prng_key(3), (2 * n_data, t, spec.spatial_size, spec.spatial_size, 3),
                    me.device)
    with torch.no_grad():
        me.sync()
        t0 = time.perf_counter()
        _, mu_sp, _ = seqpar.encode(params, seqpar.local_block(mesh, x, "seq", "data"), spec,
                                    mesh, batch_axis="data")
        me.sync()
        ms = (time.perf_counter() - t0) * 1e3
        _, mu_dense, _ = motion_encoder.apply(params, x, spec)
    want = pmesh.shard_batch(mesh, mu_dense)
    err = (mu_sp - want).abs().max().item()
    return {"mesh": {"data": n_data, "seq": n_seq}, "t": t, "max_abs_err": err, "ms": ms}


def sample_leg(me):
    mesh = pmesh.make_mesh(me.n_data, me.n_model, me.device.type)
    params = params_for(me, 4, me.spec)
    b = me.batch_rows
    batch = global_batch(me, b)
    spec = me.spec
    z = prng.normal(prng.prng_key(7), transformer.reverse_input_shape(
        spec.flow, b, spec.latent_size, spec.flow_in_channels), me.device)
    rng = prng.prng_key(8)
    local = pmesh.shard_batch(mesh, batch)
    out = {"mesh": {"data": me.n_data, "model": me.n_model}}
    for name, kw in (("z_fixed", {"z": z}), ("z_drawn", {"rng": rng})):
        me.sync()
        before = profiling.counts()
        t0 = time.perf_counter()
        got = second_stage.forward_sample(params, spec, local, add_first_frame=True, mesh=mesh,
                                          **kw)
        me.sync()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launches_since(before)
        want = pmesh.shard_batch(mesh, second_stage.forward_sample(
            params, spec, batch, add_first_frame=True, **kw)[0])
        out[name] = {"max_abs_err": (got[0] - want).abs().max().item(), "ms": ms,
                     "launches": launches, "finite": bool(torch.isfinite(got).all())}
    return out


def probe(me):
    """The three collectives of the port on this rank's device, and an
    all-reduce of 256 MB timed."""
    out = {}
    d = me.device
    x = torch.full((4, 3), float(me.rank + 1), device=d)
    checks = {
        "all_reduce": lambda: bool((distributed.sum_(x, None) == me.world * (me.world + 1) / 2)
                                   .all()),
        "all_gather": lambda: all(bool((g == i + 1).all())
                                  for i, g in enumerate(distributed.gather(x, None))),
        "broadcast": lambda: _bcast_ok(x),
    }
    for name, fn in checks.items():
        if not fn():
            raise RuntimeError(f"probe: {name} gave wrong values on {d}")
        out[name] = "ok"
    big = torch.ones(64 * 2**20, device=d)
    me.sync()
    t0 = time.perf_counter()
    dist.all_reduce(big)
    me.sync()
    out["all_reduce_256MB_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def _bcast_ok(x):
    y = x.clone()
    dist.broadcast(y, src=0)
    return bool((y == 1).all())


def run_rank(rank, world, init_method, device_type, backend, full, queue=None,
             steps_per_level=None, n_microbatches=1):
    """One rank of the dry run; puts its report (or its error) on ``queue``.
    ``n_microbatches`` > 1 adds the ``micro`` leg after ``fsdp``."""
    report = {"rank": rank}
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            device = torch.device("cpu")
            torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
        distributed.maybe_initialize(init_method, world, rank, backend, device,
                                     timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        me = Rank(rank, world, device, full, steps_per_level)
        report = me.report
        report["backend"] = dist.get_backend()
        report["probe"] = probe(me)
        me.say(f"backend {report['backend']} on {device.type}: " + ", ".join(
            f"{k} {v if isinstance(v, str) else f'{v:.1f}'}" for k, v in report["probe"].items()))
        ref = reference(me)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        distributed.barrier()

        meshes = [(me.n_data, me.n_model)] + ([(1, world)] if me.n_model == 1 and world > 1
                                               else [])
        report["ok"] = [train_leg(me, ref, d, m) for d, m in meshes]
        for i, (d, m) in enumerate(meshes):
            _check_train(me, f"ok mesh=({d},{m})", me.gathered(report["ok"][i]))
        r = report["ok"][0]
        me.say(f"ok, mesh=(data={me.n_data},model={me.n_model}), flow_loss="
               f"{r['flow_loss']:.4f}, zero_sharded_moments={r['zero_sharded_moments']}, "
               f"tp_sharded_params={r['tp_sharded_params']}, num_steps="
               f"{me.train_spec.flow.num_steps}, readings against one process "
               + _per_rank(me, [_readings(x) for x in report["ok"]])
               + f" (per rank, per mesh), step ms "
               + _per_rank(me, [x["step_ms"] for x in report["ok"]], "%.1f")
               + (f"; mesh=(data=1,model={world}) tp_sharded_params="
                  f"{report['ok'][1]['tp_sharded_params']}" if len(meshes) > 1 else ""))

        report["seqpar"] = seqpar_leg(me)
        errs = me.gathered(report["seqpar"]["max_abs_err"])
        if not max(errs) < SEQ_TOL:
            raise RuntimeError(f"seqpar mismatch {errs}")
        s = report["seqpar"]
        me.say(f"seqpar ok, mesh=(data={s['mesh']['data']},seq={s['mesh']['seq']}), "
               f"T={s['t']} time-sharded motion encode, |mu_sp-mu_dense|max per rank "
               f"{['%.2e' % e for e in errs]}")

        report["fsdp"] = train_leg(me, ref, me.n_data, me.n_model, fsdp=True)
        _check_train(me, "fsdp", me.gathered(report["fsdp"]))
        f = report["fsdp"]
        peaks = me.gathered((report["ok"][0]["peak_gib"], f["peak_gib"]))
        me.say(f"fsdp ok, mesh=(data={me.n_data},model={me.n_model}), flow_loss="
               f"{f['flow_loss']:.4f}, fsdp_sharded_params={f['fsdp_sharded_params']}, "
               f"readings against one process {_per_rank(me, _readings(f))}, step ms "
               f"{_per_rank(me, f['step_ms'], '%.1f')}, peak GiB per rank (dp, fsdp) {peaks}")
        del ref
        if n_microbatches > 1:
            report["micro"] = x = micro_leg(me, n_microbatches)
            _check_train(me, "micro", me.gathered(x))
            me.say(f"micro ok, mesh=(data={me.n_data},model={me.n_model}), n_microbatches="
                   f"{n_microbatches}, readings against one process "
                   f"{_per_rank(me, _readings(x))}, step ms {_per_rank(me, x['step_ms'], '%.1f')}")

        report["sample"] = sample_leg(me)
        allr = me.gathered(report["sample"])
        for x in allr:
            for name in ("z_fixed", "z_drawn"):
                if not (x[name]["max_abs_err"] < me.sample_tol and x[name]["finite"]):
                    raise RuntimeError(f"sharded sample mismatch: {allr}")
        me.say(f"sample ok, mesh=(data={me.n_data},model={me.n_model}), batch-sharded "
               f"forward_sample == single process, |delta|max (z fixed, z drawn) per rank "
               f"{[(x['z_fixed']['max_abs_err'], x['z_drawn']['max_abs_err']) for x in allr]}"
               f", K2 launches per rank per call "
               f"{[x['z_fixed']['launches']['macow_unit_inverse'] for x in allr]}")
        distributed.barrier()
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 - reported to the parent, then re-raised
        report["error"] = "".join(traceback.format_exception(e))
        if queue is not None:
            queue.put(report)
        raise
    if queue is not None:
        queue.put(report)
    return report


def _readings(report):
    """A train leg's readings, in TRAIN_TOLS' order."""
    return [report["errs"][k] for k in TRAIN_TOLS["cpu"]]


def _per_rank(me, value, fmt="%.2e"):
    """``value`` of every rank, formatted (lists element by element)."""
    def f(v):
        return "[" + ", ".join(f(x) for x in v) + "]" if isinstance(v, list) else fmt % v
    return f(me.gathered(value))


def run(nproc, device="cpu", backend=None, full=False, timeout=900.0, steps_per_level=None,
        n_microbatches=1):
    """Spawn ``nproc`` ranks of the dry run and wait at most ``timeout``
    seconds; returns the ranks' reports in rank order, or raises.
    ``n_microbatches`` > 1 adds the ``micro`` leg (``micro_leg``)."""
    import torch.multiprocessing as mp

    backend = backend or distributed.default_backend(device, nproc)
    if device == "cuda":   # K2 once here, not once per rank
        from ipoke_tpu_torch.ops.cuda import _build

        _build.build(("mcf_unit_inverse",))
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ipoke_dryrun_") as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=run_rank, args=(r, nproc, init, device, backend, full, queue,
                                                     steps_per_level, n_microbatches))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        reports, deadline = {}, time.monotonic() + timeout
        try:
            while len(reports) < nproc:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dry run: {nproc - len(reports)} ranks silent after "
                                       f"{timeout:.0f} s")
                try:
                    r = queue.get(timeout=2.0)
                except queue_mod.Empty:
                    if all(p.exitcode is not None for p in procs) and queue.empty():
                        raise RuntimeError(f"dry run: ranks exited with "
                                           f"{[p.exitcode for p in procs]}") from None
                    continue
                reports[r["rank"]] = r
                if "error" in r:
                    raise RuntimeError(f"dry run: rank {r['rank']} failed:\n{r['error']}")
        finally:
            for p in procs:
                p.join(timeout=30)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [reports[r] for r in range(nproc)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--full", action="store_true", help="the registry flagship at full width")
    ap.add_argument("--steps-per-level", type=int, default=None,
                    help="at most this many MaCowSteps per level in the train legs")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("dryrun: no CUDA device; pass --device cpu to run on the CPU")
    if distributed.is_multi_host_env():   # torchrun made this process one rank
        return [run_rank(int(os.environ.get("RANK", 0)), int(os.environ["WORLD_SIZE"]),
                         "env://", args.device, args.backend, args.full,
                         steps_per_level=args.steps_per_level)]
    return run(args.nproc, args.device, args.backend, args.full,
               steps_per_level=args.steps_per_level)


if __name__ == "__main__":
    main()
