"""The port's command line, the counterpart of the repository's ``main.py``:

    python -m ipoke_tpu_torch.main -c configs/second_stage.yaml -m my_model
    python -m ipoke_tpu_torch.main -c ... -m my_model --test fvd
    python -m ipoke_tpu_torch.main -c configs/img_encoder.yaml -m cond --device cpu
    python -m ipoke_tpu_torch.main -c configs/second_stage.yaml -m my_model --resume

Loads the config with ``config.load_parameters`` and trains, or tests with
``--test MODE``, the experiment ``general.experiment`` names
(``experiments.select_experiment``).  ``--resume`` trains on from the
run's ``last.npz`` (the newest version directory that holds a checkpoint;
the run's saved config wins over ``-c``), as JAX's ``main.py``'s
``restart``.  Every trainer appends its records to
``<base_dir>/<experiment>/log/<model>/metrics.jsonl``, and on SIGTERM or
SIGINT saves ``last.npz`` after the step in flight and exits.  It runs on
the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import logging

from ipoke_tpu_torch import resolve_device

TEST_MODES = ("none", "samples", "fvd", "accuracy", "diversity", "control_sensitivity",
              "transfer", "kps_acc")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.main")
    ap.add_argument("-c", "--config", default="configs/second_stage.yaml")
    ap.add_argument("-m", "--model_name", required=True)
    ap.add_argument("--test", default="none", choices=TEST_MODES)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--base_dir", default=None,
                    help="artifact root (default: config general.base_dir, else ./logs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    ap.add_argument("--max-steps", type=int, default=None, help="stop training after N steps")
    return ap.parse_args(argv)


def main(argv=None):
    """Train or test as the command line says; returns the run (the
    trainer's dict) or the test's result."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from ipoke_tpu_torch.config import load_parameters
    from ipoke_tpu_torch.experiments import select_experiment

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    config, dirs = load_parameters(args.config, args.model_name, base_dir=args.base_dir,
                                   restart=args.resume, test_mode=args.test)
    experiment = select_experiment(config, dirs)
    if args.test != "none":
        result = experiment.test(args.test, device=device)
        print(json.dumps(result, default=float), flush=True)
        return result
    else:
        run = experiment.train(device=device, max_steps=args.max_steps)
        state = run["state"]
        steps = state["step"] if isinstance(state, dict) else state.step   # a distill state is a dict
        stop = f"; preempted at step {run['preempted']}" if run["preempted"] is not None else ""
        print(f"{experiment.name}: trained {steps} steps on {device}; {len(run['val'])} "
              f"validations; checkpoints in {run['ckpt_dir']}{stop}", flush=True)
        return run


if __name__ == "__main__":
    main()
