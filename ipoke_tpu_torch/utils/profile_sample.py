"""Where the time of one ``forward_sample`` call goes, on the CUDA card.

    python -m ipoke_tpu_torch.utils.profile_sample [--mcf-backend cuda_unit|cuda|scan]
        [--artifact]

Synthesises the flagship's (iper_128) params on the card (zeroed flow output
gains, bf16 decode, as the JAX server's synthetic model), warms up, then
prints, for the MCF backend chosen (default ``'cuda_unit'``, kernel K2;
``'cuda'`` runs kernel K1 for each MCF):
  * per-stage latency (host clock around ``torch.cuda.synchronize()``):
    ``embed_cond``, ``transformer.reverse``, ``first_stage.decode``;
  * a ``torch.profiler`` window of one call: device time by kernel name,
    the device's busy share of the window, the count of launches, the
    device time and launches of K1 and K2, and those of device copies
    (kernels whose name holds memcpy, copy or flip, the concatenations'
    ``CatArrayBatchedCopy`` among them);
  * the host side of the same window: the count of host ops and the host
    ops that took the most time of their own (self CPU time);
  * with ``--artifact``: the same sampler exported at bucket 8 through
    ``serve/artifact.export_sampler`` into a temporary directory and loaded;
    its call and the live call timed in turns (live, artifact, artifact,
    live, twice), the loader's flattening and check of the inputs timed
    alone, the garbage collector's runs per call and the time of a full
    collection, the turns again with the collector off, and one artifact
    call profiled as above, with the count of the program's graph nodes by
    target;
  * one JSON line with these numbers.
Every number is the card's own; the card's name and power limit are printed
beside them.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from dataclasses import replace

import torch
from torch.profiler import ProfilerActivity, profile

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.utils import synth

MODEL, BATCH, TOP = registry.FLAGSHIP, 8, 15
KERNELS = {"mcf_inverse": "mcf_inverse_kernel", "macow_unit_inverse": "macow_unit_inverse_kernel"}
COPY = re.compile(r"memcpy|copy|flip", re.IGNORECASE)   # device copies, by kernel name


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def _on_device(evt):
    """A kernel or copy on the card, not the host op that launched it (whose
    device time would count the same kernel twice)."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA") and _device_us(evt) > 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mcf-backend", choices=("cuda_unit", "cuda", "scan"), default="cuda_unit",
                    help="MCF inverse backend of the flow (default: %(default)s)")
    ap.add_argument("--artifact", action="store_true",
                    help="also export the sampler at bucket 8, load it and profile one call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sample: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()

    spec = registry.build_specs(registry.MODELS[MODEL], mcf_backend=args.mcf_backend)
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="bf16"))
    params = synth.synth_params(spec, seed=0, device=dev)
    params = dict(params, flow=synth.zero_flow_output_convs(params["flow"]))
    fs = spec.first_stage
    g = torch.Generator(device=dev).manual_seed(1)
    b, s = BATCH, fs.spatial_size
    batch = {"images": torch.randn(b, fs.max_frames, s, s, 3, generator=g, device=dev).clamp_(-1, 1),
             "poke": torch.randn(b, s, s, 2, generator=g, device=dev)}
    z = torch.randn(b, spec.latent_size, spec.latent_size, spec.flow_in_channels,
                    generator=g, device=dev)
    length = fs.max_frames - 1

    def call():
        return second_stage.forward_sample(params, spec, batch, z=z)

    for _ in range(2):
        call()
    with torch.no_grad():
        x0 = batch["images"][:, 0]
        cond, t_cond = _timed(lambda: second_stage.embed_cond(params, spec, x0, batch["poke"]))
        motion, t_rev = _timed(lambda: transformer.reverse(params["flow"], spec.flow, z, cond))
        _, t_dec = _timed(lambda: second_stage.decode_first_stage(params, spec, motion, x0, length))
    _, t_call = _timed(call)
    stages = {"embed_cond_ms": t_cond, "reverse_ms": t_rev, "decode_ms": t_dec, "call_ms": t_call}
    print(f"[{card}] {MODEL} B={b} mcf_backend={args.mcf_backend}: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    prof = _profile(call, card, "profiled call")
    result = {"card": card, "model": MODEL, "batch": b, "mcf_backend": args.mcf_backend, **stages,
              **prof}
    if args.artifact:
        result["artifact"] = _artifact(params, spec, batch, z, card)
    print(json.dumps(result))


def _profile(call, card, what):
    """One ``torch.profiler`` window of ``call()``: device and host tables."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in events if _on_device(e)]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in events if not _on_device(e)]
    host.sort(key=lambda r: -r[1])
    host_ops = sum(r[2] for r in host)
    host_ms = sum(r[1] for r in host)
    print(f"[{card}] {what}: window {window_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / window_ms:.1f}%), {launches} device kernels/copies")
    for name, ms, n in rows[:TOP]:
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  x{n:<6d} {name[:100]}")
    print(f"[{card}] {what}: {host_ops} host ops, {host_ms:.2f} ms of self CPU time; the most:")
    for name, ms, n in host[:TOP]:
        print(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")

    def total(match):
        picked = [(ms, n) for name, ms, n in rows if match(name)]
        return {"ms": sum(ms for ms, _ in picked), "count": sum(n for _, n in picked)}

    kernels = {k: total(lambda name, sub=sub: sub in name) for k, sub in KERNELS.items()}
    copies = total(lambda name: COPY.search(name) is not None)
    for k, v in dict(kernels, copies=copies).items():
        print(f"[{card}] {what}: {k} {v['ms']:.3f} ms of device time in {v['count']} launches")
    return {"window_ms": window_ms, "device_busy_ms": busy_ms, "device_launches": launches,
            "kernels": kernels, "copies": copies, "host_ops": host_ops, "host_self_ms": host_ms,
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:TOP]],
            "host_top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in host[:TOP]]}


def _artifact(params, spec, batch, z, card):
    """The flow sampler exported at bucket ``len(z)`` and loaded, against the
    live ``forward_sample`` of the same step on the same inputs."""
    import gc
    import tempfile
    from collections import Counter

    from torch.utils import _pytree as pytree

    from ipoke_tpu_torch.serve import artifact

    b = int(z.shape[0])
    with tempfile.TemporaryDirectory(prefix="profile_sample_") as tmp:
        t0 = time.perf_counter()
        artifact.export_sampler(params, spec, tmp, buckets=(b,))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = artifact.load_artifact(tmp, z.device)
        load_s = time.perf_counter() - t0
    x0 = batch["images"][:, 0]
    nodes = Counter(str(n.target) for n in art.programs[b].graph.nodes if n.op == "call_function")

    def call():
        return art.run(art.params, x0, batch["poke"], z)

    def live():
        return second_stage.forward_sample(params, spec, batch, length=art.length,
                                           add_first_frame=True, z=z)[0]

    def inputs():   # what ``LoadedSampler.run`` does before it calls the graph
        flat, in_spec = pytree.tree_flatten(((art.params, x0, batch["poke"], z), {}))
        return in_spec == art.programs[b].call_spec.in_spec

    fns = {"live": live, "artifact": call, "inputs": inputs}

    def turns():
        ms = {"live": [], "artifact": [], "inputs": []}
        for turn in ("live", "artifact", "artifact", "live") * 2 + ("inputs",) * 3:
            ms[turn].append(_timed(fns[turn])[1])
        return ms

    for _ in range(2):
        call()
    ms = turns()
    print(f"[{card}] artifact b{b}: exported in {export_s:.1f} s, loaded in {load_s:.1f} s; "
          f"{sum(nodes.values())} call nodes; calls live {ms['live']} ms, artifact "
          f"{ms['artifact']} ms, of which flattening and checking the inputs {ms['inputs']} ms")
    print(f"[{card}] artifact b{b}: the most frequent node targets: "
          + ", ".join(f"{k} x{v}" for k, v in nodes.most_common(TOP)))
    # Python's cyclic garbage collector: collections per call, the time of
    # one full collection, and the calls again with it off
    gc_runs = {}
    for name in ("live", "artifact"):
        before = [st["collections"] for st in gc.get_stats()]
        _timed(fns[name])
        gc_runs[name] = [st["collections"] - n for st, n in zip(gc.get_stats(), before)]
    t0 = time.perf_counter()
    gc.collect()
    gc_full_ms = (time.perf_counter() - t0) * 1e3
    gc.disable()
    try:
        ms_no_gc = turns()
    finally:
        gc.enable()
    print(f"[{card}] artifact b{b}: collections per call by generation: live {gc_runs['live']}, "
          f"artifact {gc_runs['artifact']}; one full collection {gc_full_ms:.1f} ms; with the "
          f"collector off: live {ms_no_gc['live']} ms, artifact {ms_no_gc['artifact']} ms")
    prof = _profile(call, card, f"artifact b{b} profiled call")
    return {"export_s": export_s, "load_s": load_s, "call_ms": ms, "nodes": dict(nodes),
            "gc_collections": gc_runs, "gc_full_ms": gc_full_ms, "call_ms_no_gc": ms_no_gc,
            **prof}


if __name__ == "__main__":
    main()
