"""Where the time of one stage-2 train step goes, on the CUDA card.

    python -m ipoke_tpu_torch.utils.profile_train

Draws the flagship's (iper_128) params at full width and depth with the
port's ``init`` (JAX's draw, seed 0) on the card, builds the train step as
``experiments/second_stage.train`` does (torch-Adam, lr 1e-3 after 2 warm-up
steps, weight decay 1e-5, B=8 of the synthetic dataset), runs two warm-up
steps, then prints:
  * the host time of STEPS steps, each to a synchronised device, and
    the peak ``max_memory_allocated``;
  * one more step taken apart as ``make_train_step`` runs it (forward and
    loss, ``torch.autograd.grad``, the optimizer update), each part in a
    ``torch.profiler`` window of its own between synchronisations: its host
    time, the device's busy time and launches in it, device time by kernel
    name (the backward runs on autograd's own thread, so a profiler range
    on the step's thread would not hold its kernels);
  * one JSON line with these numbers.
Every number is the card's own; the card's name and power limit are printed
beside them.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.data.synthetic import SyntheticConfig, SyntheticPokeDataset, train_batches
from ipoke_tpu_torch.flows.loss import flow_loss
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.train import second_stage as train
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.profile_sample import TOP, _card, _device_us, _on_device

MODEL, BATCH, STEPS = registry.FLAGSHIP, 8, 3


def _profiled(fn):
    """fn() in a profiler window between synchronisations: (result, host ms,
    [(kernel name, device ms, launches)] by device time)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if _on_device(e)), key=lambda r: -r[1])
    return out, host_ms, rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card()

    entry = registry.MODELS[MODEL]
    spec = registry.build_specs(entry)
    t0 = time.perf_counter()
    params = second_stage.init(prng.prng_key(0), spec, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trainable, frozen = train.split_params(params)
    opt = train.make_optimizer(lr=1e-3, weight_decay=1e-5, warmup_steps=2, total_steps=1000)
    state = train.init_state(trainable, opt)
    step = train.make_train_step(spec, frozen, opt)
    data = SyntheticPokeDataset(SyntheticConfig(spatial_size=entry.spatial_size,
                                                max_frames=entry.max_frames, n_examples=2 * BATCH))
    batches = train_batches(data, BATCH)
    rng = prng.prng_key(0)

    def next_batch():
        return {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items() if k != "sample_ids"}

    def one():
        nonlocal state, rng
        batch = next_batch()
        rng, sub = prng.split(rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, sub)
        loss = float(metrics["flow_loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss

    torch.cuda.reset_peak_memory_stats()
    warm = [one() for _ in range(2)]
    timed = [one() for _ in range(STEPS)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] {MODEL} B={BATCH} train step: init {init_s:.2f} s; warm-up "
          f"{', '.join(f'{ms:.1f}' for ms, _ in warm)} ms; steps "
          f"{', '.join(f'{ms:.1f}' for ms, _ in timed)} ms; losses "
          f"{', '.join(f'{loss:.4f}' for _, loss in warm + timed)}; peak {peak:.2f} GiB")

    batch, (rng, key) = next_batch(), prng.split(rng)
    params = {**frozen, **state.params}
    leaves = train.float_leaves(state.params)

    def forward():
        out, logdet, _ = second_stage.forward_density(params, spec, batch)
        return flow_loss(out, logdet, key=key)[0]

    loss, fwd_ms, fwd = _profiled(forward)
    grads, bwd_ms, bwd = _profiled(lambda: torch.autograd.grad(loss, leaves))
    _, opt_ms, upd = _profiled(lambda: train.apply_updates(opt, state, list(grads)))
    phases = {}
    for name, host_ms, rows in (("forward", fwd_ms, fwd), ("backward", bwd_ms, bwd),
                                ("optimizer", opt_ms, upd)):
        busy = sum(r[1] for r in rows)
        phases[name] = {"host_ms": host_ms, "device_busy_ms": busy,
                        "device_launches": sum(r[2] for r in rows),
                        "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:TOP]]}
        print(f"[{card}] profiled {name}: {host_ms:.2f} ms on the host, device busy {busy:.2f} ms "
              f"({100 * busy / host_ms:.1f}%), {phases[name]['device_launches']} device "
              f"kernels/copies")
        for n, ms, c in rows[:TOP]:
            print(f"  {ms:9.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  x{c:<6d} {n[:100]}")
    total = {k: sum(p[k] for p in phases.values())
             for k in ("host_ms", "device_busy_ms", "device_launches")}
    print(f"[{card}] profiled step in three parts: {total['host_ms']:.2f} ms on the host, device "
          f"busy {total['device_busy_ms']:.2f} ms ({100 * total['device_busy_ms'] / total['host_ms']:.1f}%), "
          f"{total['device_launches']} device kernels/copies")
    print(json.dumps({"card": card, "model": MODEL, "batch": BATCH, "init_s": init_s,
                      "warmup_ms": [ms for ms, _ in warm], "step_ms": [ms for ms, _ in timed],
                      "peak_gib": peak, "profiled": total, "phases": phases}))


if __name__ == "__main__":
    main()
