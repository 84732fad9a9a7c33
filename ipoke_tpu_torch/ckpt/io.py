"""Checkpoints in the JAX package's npz format (the port's copy of
``ipoke_tpu/ckpt/io.py``) and checkpoint discovery.

A tree of nested dicts and lists is stored flat, one array per leaf, under
its path joined by ``::``; a list node adds ``<path>::__len__``, an empty
dict ``<path>::__empty__``, a None ``<path>::__none__``, and metadata goes
to ``__metadata__`` as JSON bytes.  ``save`` takes numpy arrays (or numbers);
``ckpt/jax_bridge`` moves the port's tensors into the JAX package's layouts
and back.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

SEP = "::"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{SEP}__empty__"] = np.asarray(0)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}{SEP}__len__"] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}{i}"))
    elif tree is None:
        out[f"{prefix}{SEP}__none__"] = np.asarray(0)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat):
    """The flat npz dict -> nested dicts and lists of numpy arrays."""
    root = {}
    lens = {k[: -len(SEP + "__len__")]: int(v) for k, v in flat.items()
            if k.endswith(SEP + "__len__")}
    for key, val in flat.items():
        if key.endswith(SEP + "__len__"):
            continue
        parts = key.split(SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(val)

    def listify(node, prefix=""):
        if not isinstance(node, dict):
            return node
        if "__empty__" in node:
            return {}
        if "__none__" in node:
            return None
        out = {k: listify(v, f"{prefix}{SEP}{k}" if prefix else k) for k, v in node.items()}
        if prefix in lens:
            return [out[str(i)] for i in range(lens[prefix])]
        return out

    return listify(root)


def save(path, tree, metadata=None):
    """Write ``tree`` (numpy leaves) to the npz ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    if metadata:
        flat["__metadata__"] = np.frombuffer(json.dumps(metadata).encode(), np.uint8)
    np.savez(path, **flat)


def load(path):
    """(tree of numpy arrays, metadata dict or None) of an npz checkpoint."""
    path = str(path)
    with np.load(path if path.endswith(".npz") else f"{path}.npz", allow_pickle=False) as f:
        data = dict(f)
    meta = None
    if "__metadata__" in data:
        meta = json.loads(bytes(data.pop("__metadata__")).decode())
    return _unflatten(data), meta


def datapath_rewrite(path):
    """``path`` under ``$DATAPATH`` when that is set and the path is not
    already under it."""
    dp = os.environ.get("DATAPATH")
    if dp and not path.startswith(dp):
        return os.path.join(dp, path.lstrip("/"))
    return path


class CheckpointManager:
    """Top-k checkpoints on a metric (least is best), ``last.npz`` beside
    them, and ``best_k_models.json`` (read by ``find_best``)."""

    def __init__(self, ckpt_dir, monitor="FVD-val", top_k=5):
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.top_k = top_k
        self.best_k = {}  # path -> value
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_step(self, tree, step, metric_value, metadata=None):
        meta = dict(metadata or {})
        meta.update({"step": int(step), self.monitor: float(metric_value)})
        path = os.path.join(
            self.ckpt_dir, f"step={int(step)}-{self.monitor}={float(metric_value):.3f}.npz")
        save(path, tree, meta)
        self.best_k[path] = float(metric_value)
        if len(self.best_k) > self.top_k:
            worst = max(self.best_k, key=self.best_k.get)
            self.best_k.pop(worst)
            if os.path.exists(worst):
                os.remove(worst)
        save(os.path.join(self.ckpt_dir, "last.npz"), tree, meta)
        with open(os.path.join(self.ckpt_dir, "best_k_models.json"), "w") as f:
            json.dump(self.best_k, f, indent=2)
        try:   # the reference tooling's yaml mirror; find_best reads the json
            import yaml
        except ImportError:
            return path
        with open(os.path.join(self.ckpt_dir, "best_k_models.yaml"), "w") as f:
            yaml.safe_dump(self.best_k, f)
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
