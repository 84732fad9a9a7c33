"""Per-stage times of the SPADE frame decode on the CUDA card (the port's
counterpart of ``ipoke_tpu/utils/profile_decode.py``).

    python -m ipoke_tpu_torch.utils.profile_decode [--model iper_128] \\
        [--batch 128] [--iters 5] [--dtype bf16|f32] [--length N]

At a registry model's first-stage width, params synthesised from seed 0
(``synth.synth_first_stage``), the decoder's params cast to ``--dtype``:
the full decode (``first_stage.decode``, f32 params and start frame, the
cast inside as in sampling), the GRU unroll, the SPADE precompute, then per
frame at batch B the in-block, each upsampling stage (res block + SPADE
with the precomputed modulation) at its resolution, and the out conv.  For
each: ``s``, the median over ``--iters`` of host time to a synchronised
card, and ``pipelined_s``, max(iters, 5) calls then one synchronise, per
call; beside them the port's own count of the work: ``flops_counted``
(``torch.utils.flop_counter.FlopCounterMode``: convolutions and matmuls)
and ``bytes_counted`` (the inputs, params and output, each once).  Prints
one JSON line with the card's name and power limit.  ``--device cpu`` runs
it on the CPU, only when asked.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import replace

import torch
from torch.utils.flop_counter import FlopCounterMode

from ipoke_tpu_torch import registry, resolve_device
from ipoke_tpu_torch.models import conv_gru, decoder, first_stage
from ipoke_tpu_torch.nn import blocks as nnb
from ipoke_tpu_torch.train.second_stage import leaves
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.synth import synth_first_stage

COUNT_BY = ("flops_counted: torch.utils.flop_counter.FlopCounterMode (convolutions and "
            "matmuls); bytes_counted: the inputs, params and output, each once")


def _bytes(*trees):
    return sum(t.numel() * t.element_size() for tree in trees for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _timer(iters, device):
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def bench(fn, *args):
        """(latency s, pipelined s, counted flops, counted bytes) of ``fn(*args)``."""
        with FlopCounterMode(display=False) as counter:
            out = fn(*args)
        flops = counter.get_total_flops()
        nbytes = _bytes(list(args), out)
        float(out.float().sum())   # warm: cuDNN's plans, the allocator
        ts = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            float(fn(*args).float().sum())
            sync()
            ts.append(time.perf_counter() - t0)
        n = max(iters, 5)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        float(out.float().sum())
        sync()
        return statistics.median(ts), (time.perf_counter() - t0) / n, flops, nbytes

    return bench


@torch.no_grad()
def profile(spec, batch, iters, dtype="bf16", length=None, device=None):
    """The per-stage report of ``main`` for a ``FirstStageSpec``, as a dict."""
    device = resolve_device(device)
    spec = replace(spec, decode_dtype=dtype)
    dec_spec = spec.decoder_spec
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    b, s0, size = batch, spec.min_spatial_size, spec.spatial_size
    length = length or (spec.max_frames - 1)
    params = synth_first_stage(spec, seed=0, device=device)
    gen = first_stage._cast_floats(params["gen"], dt)
    motion = prng.normal(prng.prng_key(1), (b, s0, s0, spec.z_dim), device)
    start = prng.normal(prng.prng_key(2), (b, size, size, 3), device).to(dt)
    bench = _timer(iters, device)
    res = {"batch": b, "dtype": dtype, "length": length, "count_by": COUNT_BY}

    def record(name, fn, *args):
        lat, pipe, flops, nbytes = bench(fn, *args)
        res[name] = {"s": lat, "pipelined_s": pipe, "flops_counted": flops,
                     "bytes_counted": nbytes}

    dec_params = {k: params[k] for k in ("rnn", "gen", "motion_bias")}   # what decode reads
    record("full_decode", lambda p, m, x0: first_stage.decode(p, m, x0, spec, length),
           dec_params, motion, start.float())

    bias = params["motion_bias"].to(motion.dtype)
    in_rnn = bias.expand((b,) + tuple(bias.shape[1:]))

    def gru_all(rnn_p, m):
        hidden = [m] * spec.n_gru_layers
        tops = []
        for _ in range(length):
            hidden = conv_gru.stack_apply(rnn_p, in_rnn, hidden)
            tops.append(hidden[-1])
        return torch.stack(tops)

    record("gru_unroll", gru_all, params["rnn"], motion)
    record("spade_precompute",
           lambda g, x0: decoder.precompute_spade_feats(g, x0, dec_spec)[0]["gamma"], gen, start)

    # per frame at batch b: the in-block at s0, each upsampling stage at its
    # resolution, the out conv; times `length` compares with full_decode
    hid = prng.normal(prng.prng_key(3), (b, s0, s0, spec.z_dim), device).to(dt)
    record("in_block_per_frame", lambda p, h: nnb.res_block_apply(p, h, norm=dec_spec.norm),
           gen["in_block"], hid)
    feats = decoder.precompute_spade_feats(gen, start, dec_spec)
    res_in = s0
    x = prng.normal(prng.prng_key(4), (b, s0, s0, dec_spec.dec_channels[0]), device).to(dt)
    for i, nf in enumerate(dec_spec.dec_channels[1:]):
        def stage(bp, sp, x_, mod):
            y = nnb.res_block_apply(bp, x_, norm="none", upsampling=True)
            return nnb.spade_apply(sp, y, None, shared_mod=mod)

        record(f"stage{i}_{res_in}to{res_in * 2}_c{nf}_per_frame", stage,
               gen["blocks"][i], gen["spades"][i], x, feats[i])
        res_in *= 2
        x = prng.normal(prng.prng_key(5 + i), (b, res_in, res_in, nf), device).to(dt)
    record("out_conv_per_frame",
           lambda p, x_: nnb.conv2d_block_apply(p, x_, stride=1, padding=1, norm="none",
                                                act="tanh"),
           gen["out_conv"], x)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.utils.profile_decode")
    ap.add_argument("--model", default=registry.FLAGSHIP)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--length", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    spec = registry.build_specs(registry.MODELS[args.model]).first_stage
    res = profile(spec, args.batch, args.iters, args.dtype, args.length, device)
    if device.type == "cuda":
        from ipoke_tpu_torch.utils.kernel_bench import card_line

        res["device"] = card_line()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    else:
        res["device"] = str(device)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
