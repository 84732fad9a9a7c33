"""Checkpoint discovery (the port's copy of what serving needs from
``ipoke_tpu/ckpt/io.py``).  The npz format itself is read by
``ckpt/jax_bridge.load_npz``."""
from __future__ import annotations

import json
import os
import re


def datapath_rewrite(path):
    """``path`` under ``$DATAPATH`` when that is set and the path is not
    already under it."""
    dp = os.environ.get("DATAPATH")
    if dp and not path.startswith(dp):
        return os.path.join(dp, path.lstrip("/"))
    return path


def find_best(ckpt_dir):
    """The best checkpoint of a run directory: ``best_k_models.json`` if
    present, else the least metric value parsed from ``...=<value>.npz``
    file names, else ``last.npz``; None when there is none."""
    bk = os.path.join(ckpt_dir, "best_k_models.json")
    if os.path.exists(bk):
        with open(bk) as f:
            best_k = json.load(f)
        if best_k:
            return min(best_k, key=best_k.get)
    cands = []
    for f in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        m = re.search(r"=(\d+\.?\d*)\.npz$", f)
        if m and f != "last.npz":
            cands.append((float(m.group(1)), os.path.join(ckpt_dir, f)))
    if cands:
        return min(cands)[1]
    last = os.path.join(ckpt_dir, "last.npz")
    return last if os.path.exists(last) else None
