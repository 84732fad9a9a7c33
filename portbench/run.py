"""One run of one benchmark cell on the CUDA card: set-up, a measured window,
the output check, one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a traced window after the measured
one) and a ``breakdown``.  Every run checks what the timed path produced
against the frozen plain reference and prints each number compared beside
its limit, as its last lines on standard error and last in the JSON line.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):   # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import layout  # noqa: E402
from portbench.result import Ctx  # noqa: E402

# nothing of JAX may be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "ipoke_tpu")


def cache_dirs(root):
    """Every build and kernel cache under the checkout, at fixed paths."""
    base = Path(root) / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name, seed, seconds, trace, device, pkg=layout.PKG, root=layout.ROOT):
    """Drive cell ``name`` on ``device`` and build its result line (a dict)."""
    import torch
    cell = layout.cell(name, pkg)
    cfg = layout.config(cell["config"], pkg)
    traffic = layout.traffic(cell["traffic"], pkg)
    bench = layout.benchmark(root)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    ctx = Ctx(name, cell, cfg, traffic, int(seed), float(seconds), bool(trace), device, T_START)
    out = layout.driver(traffic["kind"], pkg).run(ctx)
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if layout.applies(m, name):
                value = layout.metric(m["name"], pkg).read(out.readings)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if layout.applies(m, name):
                if m["name"] not in out.e2e:
                    raise RuntimeError(f"portbench: cell {name} measured no {m['name']}")
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    correct = out.failed == 0 and all(v <= lim for v, lim in out.checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        dev["busy_s"] = out.readings["busy_s"]
        dev["window_s"] = out.readings["window_s"]
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(layout.ROOT)
    import torch

    import ipoke_tpu_torch  # noqa: F401  (the system under test: a checkout without it cannot run)
    cell = layout.cell(args.workload)
    if not torch.cuda.is_available():
        sys.exit("portbench: torch.cuda.is_available() is false; the benchmark runs on a CUDA card")
    if torch.cuda.device_count() < cell["chips"]:
        sys.exit(f"portbench: cell {args.workload} needs {cell['chips']} cards, "
                 f"{torch.cuda.device_count()} visible")
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        sys.exit(f"portbench: the process loaded {bad}; nothing of JAX may run here")
    print(f"correct {line['correct']}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
