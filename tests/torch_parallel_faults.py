"""Faults planted in the sharded train step, each of which the dry run's
check of a train leg must call wrong.

    PYTHONPATH=. python tests/torch_parallel_faults.py [--nproc 2]
        [--device cpu|cuda] [--full] [--out FILE]

In every rank of a gloo world (``tests/torch_parallel_worker.World``; on
``cuda`` all ranks on the card, round robin) the data-parallel leg of
``parallel/dryrun`` (``data`` = the world, ZeRO-1) runs once as it is and
once under each fault of ``FAULTS``, all against one one-process reference:

* ``no_data_all_reduce``: the gradients are not summed over ``data``, so each
  rank steps on the gradient of its own rows;
* ``no_update``: the optimizer's updates are not applied (its moments move);
* ``half_batch``: each rank trains on half of its rows.

It prints each leg's readings per rank (``dryrun.TRAIN_TOLS``) and exits
with 1 unless the sound leg is held and every fault is called wrong on every
rank.  ``tests/test_torch_parallel.py`` runs it on the CPU at the dry run's
tiny width; ``--full`` takes the registry flagship at full width.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

FAULTS = ("no_data_all_reduce", "no_update", "half_batch")


@contextlib.contextmanager
def plant(fault):
    """``fault`` planted in the port's modules for the length of the block."""
    from ipoke_tpu_torch.parallel import mesh as pmesh
    from ipoke_tpu_torch.train import second_stage as train_ss

    if fault == "no_data_all_reduce":
        where, name = train_ss, "_sum_in_buckets"
        new = lambda tensors, group, **kw: None  # noqa: E731
    elif fault == "no_update":
        where, name = train_ss.Optimizer, "update"
        update = train_ss.Optimizer.update

        def new(self, grads, state, params):
            return [torch.zeros_like(u) for u in update(self, grads, state, params)]
    elif fault == "half_batch":
        where, name = pmesh, "shard_batch"
        shard = pmesh.shard_batch

        def new(mesh, batch):
            return {k: v[:v.shape[0] // 2] for k, v in shard(mesh, batch).items()}
    else:
        raise ValueError(f"no fault {fault!r}")
    old = getattr(where, name)
    setattr(where, name, new)
    try:
        yield
    finally:
        setattr(where, name, old)


def fault_case(rank, n, device="cpu", full=False, faults=FAULTS):
    """This rank's readings of the sound data-parallel leg and of each fault's."""
    from ipoke_tpu_torch.parallel import dryrun

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    me = dryrun.Rank(rank, n, dev, full)
    ref = dryrun.reference(me)
    legs = {"sound": dryrun.train_leg(me, ref, n, 1)}
    for fault in faults:
        with plant(fault):
            legs[fault] = dryrun.train_leg(me, ref, n, 1)
    return {k: {"errs": v["errs"], "held": dryrun.held(v, me.train_tols),
                "step_ms": v["step_ms"]} for k, v in legs.items()}


def verdict(per_rank):
    """The legs that came out otherwise than they should: the sound leg not
    held, or a fault held, on some rank."""
    return [(r, k) for r, legs in enumerate(per_rank) for k, leg in legs.items()
            if leg["held"] != (k == "sound")]


def main(argv=None):
    from torch_parallel_worker import World

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_parallel_faults: no CUDA device; pass --device cpu")
    per_rank = World(args.nproc, [("faults", fault_case,
                                   {"device": args.device, "full": args.full})],
                     timeout=args.timeout, device=args.device).result()["faults"]
    from ipoke_tpu_torch.parallel import dryrun

    tols = dryrun.TRAIN_TOLS[args.device]
    for r, legs in enumerate(per_rank):
        for k, leg in legs.items():
            print(f"rank {r} {k:>18}: held={leg['held']} " + ", ".join(
                f"{x} {leg['errs'][x]:.3g}" for x in tols) + " step ms "
                + ", ".join(f"{t:.1f}" for t in leg["step_ms"]), flush=True)
    bad = verdict(per_rank)
    result = {"device": args.device, "full": args.full, "tolerances": tols,
              "ranks": per_rank, "wrong": bad}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"faults_called_wrong": not bad, "wrong": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
