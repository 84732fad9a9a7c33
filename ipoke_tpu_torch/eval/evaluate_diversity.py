"""Diversity of saved sample tensors (the port's counterpart of
``ipoke_tpu/eval/evaluate_diversity.py``; the reference's
testing/evaluate_diversity.py:14-98): an npy of (n_ex, n_samples, T, H, W, 3)
or (n_ex, n_samples, T, 3, H, W), uint8 or [-1, 1] float, scored by
``metrics/diversity`` on the card (``--device cpu`` when asked); one JSON
line on stdout.

    python -m ipoke_tpu_torch.eval.evaluate_diversity --samples samples.npy [--repr vgg]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.metrics import diversity


def load_samples(path, max_examples=100):
    """The npy at ``path`` as (n_ex, n_samples, T, H, W, 3) float32 in [-1, 1]."""
    arr = np.load(path)
    if arr.ndim == 6 and arr.shape[3] == 3:   # (n, s, T, C, H, W)
        arr = np.transpose(arr, (0, 1, 2, 4, 5, 3))
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 127.5 - 1.0
    return np.ascontiguousarray(arr[:max_examples], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.eval.evaluate_diversity")
    ap.add_argument("--samples", required=True, help="npy (n_ex, n_samples, T, H, W, 3) or NCHW")
    ap.add_argument("--repr", default="all", choices=["vgg", "mse", "lpips", "all"])
    ap.add_argument("--max_examples", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    x = torch.from_numpy(load_samples(args.samples, args.max_examples)).to(device)
    out = {}
    if args.repr in ("vgg", "all"):
        out["div_vgg_cosine"] = diversity.div_score_vgg(x)
    if args.repr in ("mse", "all"):
        out["div_mse"] = diversity.div_score_mse(x)
    if args.repr in ("lpips", "all"):
        out["div_lpips"] = diversity.div_score_lpips(x)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
