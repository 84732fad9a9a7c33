"""Test modes over a list of model names, one process per model (the port's
counterpart of ``ipoke_tpu/eval/eval_models.py``; the reference's
testing/eval_models.py).  Each model runs the port's own CLI,
``python -m ipoke_tpu_torch.experiments.second_stage test``, and its
``generated/metrics/<mode>.json`` is gathered into one JSON on stdout.

    python -m ipoke_tpu_torch.eval.eval_models -e fvd --names configs/model_names.txt \\
        [-c configs/second_stage.yaml] [--base_dir logs] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ipoke_tpu_torch.eval.test_modes import MODES


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.eval.eval_models")
    ap.add_argument("-e", "--eval", default="fvd", choices=list(MODES))
    ap.add_argument("--names", default="configs/model_names.txt")
    ap.add_argument("-c", "--config", default="configs/second_stage.yaml")
    ap.add_argument("--base_dir", default="logs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    from ipoke_tpu_torch.config import load_yaml

    with open(args.names) as f:
        names = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    experiment = load_yaml(args.config)["general"]["experiment"]
    results = {}
    for name in names:
        # one process per model: each starts with a fresh device state
        cmd = [sys.executable, "-m", "ipoke_tpu_torch.experiments.second_stage", "test",
               "-c", args.config, "-m", name, "--mode", args.eval, "--base_dir", args.base_dir]
        if args.device:
            cmd += ["--device", args.device]
        print(f"== {name}: {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        results[name] = {"returncode": proc.returncode, "tail": (proc.stdout + proc.stderr)[-500:]}
        metrics = os.path.join(args.base_dir, experiment, "generated", name, "metrics",
                               f"{args.eval}.json")
        if os.path.exists(metrics):
            with open(metrics) as f:
                results[name]["metrics"] = json.load(f)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
