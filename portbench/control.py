"""Readings of a cell's control and faults, from which its limits are set.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13

For each seed, in one process: the numbers a run of the cell compares, read
for the port (the lower readings of the limits), for the control and, in a
training cell, for a fault.  The control is the frozen reference put in the
port's place and computed in the next precision below the configuration's:
float32 convolutions and matrix products in TF32.  A sampling cell reads the
largest |x - reference| over the videos of one call at the cell's size; a
training cell reads its compared numbers over its checked steps, and also
for the fault of half of each batch left out (the loss a mean over the other
half).  The benchmark's own runs never run this; each line printed is one
seed's readings, beside the cell's limits.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys

import torch

from portbench import layout
from portbench.port import port_spec
from portbench.result import Ctx


@contextlib.contextmanager
def tf32():
    """float32 convolutions and matrix products in TF32 inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def sample_control(ctx, drv, lower=tf32):
    """Largest |port - reference| and |reference in ``lower`` precision -
    reference| over call 0's videos."""
    from ipoke_tpu_torch.models import second_stage
    from portbench.reference import sample as ref
    params = drv.make_params(ctx)
    images, pokes, z = drv.call_inputs(ctx, 0)
    length = ctx.traffic["frames"] - 1
    port = second_stage.forward_sample(params, port_spec(ctx.config),
                                       {"images": images, "poke": pokes}, z=z, length=length)
    want = ref.forward_sample(params, ctx.config, images, pokes, z, length)
    with lower():
        control = ref.forward_sample(params, ctx.config, images, pokes, z, length)
    return {"port": {"video_max_abs": float((port - want).abs().max())},
            "control": {"video_max_abs": float((control - want).abs().max())}}


def gan_control(ctx, drv, lower=tf32):
    """The training numbers of the port, of the control (the reference in
    ``lower`` precision) and of the half-batch fault, each against the
    reference, from the same weights, batches and keys."""
    nets = drv.make_nets(ctx)
    start_nets = copy.deepcopy(nets)
    state, step = drv.port_step(ctx, nets)
    state, port = drv.checked_steps(ctx, state, step, {n: drv.trained(start_nets[n]) for n in drv.ref.NETS})
    del state, step, nets
    want = drv.reference_readings(ctx, start_nets)
    with lower():
        control = drv.reference_readings(ctx, start_nets)
    full_batch = drv.batch
    drv.batch = lambda c, i: full_batch(c, i)[: c.traffic["batch"] // 2]
    try:
        fault = drv.reference_readings(ctx, start_nets)
    finally:
        drv.batch = full_batch
    rule = ctx.cell["leaf_rule"]
    return {name: drv.compare(got, want, rule)
            for name, got in (("port", port), ("control", control), ("half_batch", fault))}


def readings(name, seed, device, pkg=layout.PKG):
    cell = layout.cell(name, pkg)
    cfg = layout.config(cell["config"], pkg)
    traffic = layout.traffic(cell["traffic"], pkg)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    ctx = Ctx(name, cell, cfg, traffic, int(seed), 0.0, False, device, 0.0)
    drv = layout.driver(traffic["kind"], pkg)
    read = {"sample": sample_control, "gan": gan_control}[traffic["kind"]]
    return read(ctx, drv)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("portbench.control: no CUDA card; the control is read on the card")
    dev = torch.device("cuda", 0)
    limits = layout.cell(args.workload)["limits"]
    for seed in args.seeds.split(","):
        out = readings(args.workload, int(seed), dev)
        print(json.dumps({"workload": args.workload, "seed": int(seed), "readings": out,
                          "limits": limits}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
