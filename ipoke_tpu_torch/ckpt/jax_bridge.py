"""Carry weights across from the JAX package.

Turns a second-stage param tree of ``ipoke_tpu`` (nested dicts and lists of
numpy arrays, or an npz written by its ``ckpt/io.save``) into the port's
params:

* every conv kernel HWIO -> OIHW; transpose-conv kernels (the SPADE
  decoder's upsampling blocks, a growing ``conv_adapt_*``) -> ``(in, out,
  kh, kw)``; weight-norm ``v`` likewise, ``g`` carried as it is (the port
  materialises ``w = g v / ||v||`` at run time, as the JAX package does);
* the MaCowSteps of a level, stacked on a leading axis in JAX, become a list;
* int permutation buffers become ``torch.long``;
* what sampling does not use is dropped: the motion encoder
  (``first_stage.enc_motion``), the decoder half of the tower wrappers and the
  spectral-norm vectors ``u``.
"""
from __future__ import annotations

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device

SEP = "::"   # key separator of the JAX package's npz format


def _unflatten(flat):
    """The JAX package's ``::``-flattened npz dict -> nested dicts and lists."""
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


def load_npz(path):
    """Numpy param tree (and metadata dict or None) of an ``ipoke_tpu`` npz."""
    import json

    with np.load(path if str(path).endswith(".npz") else f"{path}.npz", allow_pickle=False) as f:
        data = dict(f)
    meta = None
    if "__metadata__" in data:
        meta = json.loads(bytes(data.pop("__metadata__")).decode())
    return _unflatten(data), meta


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unstack(v, i) for v in tree]
    return tree[i]


def _n_stacked(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def _convert(tree, device, transposed=False):
    """Leaves to tensors; 4D kernels 'w'/'v' to the port's layouts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "u":
                continue
            if k in ("w", "v") and not isinstance(v, (dict, list)) and np.ndim(v) == 4:
                v = np.asarray(v)
                v = v.transpose(2, 3, 0, 1) if transposed else v.transpose(3, 2, 0, 1)
                out[k] = torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            else:
                out[k] = _convert(v, device, transposed)
        return out
    if isinstance(tree, list):
        return [_convert(v, device, transposed) for v in tree]
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def bridge_flow(tree, device=None):
    """The JAX multiscale flow tree ({'levels': [...]}) -> the port's."""
    device = resolve_device(device)
    levels = []
    for level in tree["levels"]:
        steps = level["steps"]
        levels.append({
            "steps": [_convert(_unstack(steps, i), device) for i in range(_n_stacked(steps))],
            "prior": _convert(level["prior"], device),
            "shuffle": _convert(level["shuffle"], device),
        })
    return {"levels": levels}


def _bridge_first_stage(fs, device):
    gen = fs["gen"]
    out = {
        "rnn": _convert(fs["rnn"], device),
        "gen": {
            "in_block": _convert(gen["in_block"], device),
            # upsampling res blocks: res_conv and conv1 are transpose convs
            "blocks": [dict(_convert({k: v for k, v in b.items() if k != "conv2"}, device,
                                     transposed=True),
                            conv2=_convert(b["conv2"], device)) for b in gen["blocks"]],
            "spades": _convert(gen["spades"], device),
            "out_conv": _convert(gen["out_conv"], device),
        },
    }
    if "motion_bias" in fs:
        out["motion_bias"] = _convert(fs["motion_bias"], device)
    return out


def bridge_second_stage(tree, spec, device=None):
    """The JAX second-stage tree (or the path of its npz) -> the port's params.

    ``spec`` is the port's SecondStageSpec; it says which size adapters grow
    (transpose conv) and which shrink.
    """
    device = resolve_device(device)
    if isinstance(tree, (str, bytes)) or hasattr(tree, "__fspath__"):
        tree, _ = load_npz(tree)
    out = {
        "flow": bridge_flow(tree["flow"], device),
        "first_stage": _bridge_first_stage(tree["first_stage"], device),
        "poke_embedder": {"encoder": _convert(tree["poke_embedder"]["encoder"], device)},
    }
    if "conditioner" in tree:
        out["conditioner"] = {"encoder": _convert(tree["conditioner"]["encoder"], device)}
    s = spec.first_stage.min_spatial_size
    for name, wspec in (("conv_adapt_poke_emb", spec.poke_embedder),
                        ("conv_adapt_cond", spec.conditioner)):
        if name in tree:
            out[name] = _convert(tree[name], device, transposed=wspec.min_spatial_size < s)
    return out
