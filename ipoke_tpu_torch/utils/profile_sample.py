"""Where the time of one ``forward_sample`` call goes, on the CUDA card.

    python -m ipoke_tpu_torch.utils.profile_sample [--mcf-backend cuda_unit|cuda|scan]

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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages() if _on_device(e)]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"[{card}] profiled call: window {window_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / window_ms:.1f}%), {launches} device kernels/copies")
    for name, ms, n in rows[:TOP]:
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  x{n:<6d} {name[:100]}")

    def total(match):
        picked = [(ms, n) for name, ms, n in rows if match(name)]
        return {"ms": sum(ms for ms, _ in picked), "count": sum(n for _, n in picked)}

    kernels = {k: total(lambda name, sub=sub: sub in name) for k, sub in KERNELS.items()}
    copies = total(lambda name: COPY.search(name) is not None)
    for k, v in dict(kernels, copies=copies).items():
        print(f"[{card}] profiled call: {k} {v['ms']:.3f} ms of device time in {v['count']} launches")
    result = {"card": card, "model": MODEL, "batch": b, "mcf_backend": args.mcf_backend, **stages,
              "window_ms": window_ms, "device_busy_ms": busy_ms, "device_launches": launches,
              "kernels": kernels, "copies": copies,
              "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:TOP]]}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
