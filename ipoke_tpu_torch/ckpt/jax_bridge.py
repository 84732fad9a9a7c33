"""Carry weights across between the JAX package and the port.

``bridge_second_stage`` turns a second-stage param tree of ``ipoke_tpu``
(nested dicts and lists of numpy arrays, or an npz written by its
``ckpt/io.save``) into the port's params:

* every conv kernel HWIO -> OIHW (3D: DHWIO -> OIDHW); transpose-conv
  kernels (the SPADE decoder's upsampling blocks, a growing
  ``conv_adapt_*``) -> ``(in, out, kh, kw)``; weight-norm ``v`` likewise,
  ``g`` carried as it is (the port materialises ``w = g v / ||v||`` at run
  time, as the JAX package does);
* the MaCowSteps of a level, stacked on a leading axis in JAX, become a list;
* int permutation buffers become ``torch.long``;
* what the port does not use is dropped: the decoder half of the tower
  wrappers and the spectral-norm vectors ``u`` (a conv-LU's ``u``, its upper
  factor, stays);
* a MultiscaleStack flow (``{"blocks", "h_transforms"}``) bridges block by
  block; an ``up`` stack's h transforms are transpose convs, told by the
  midpoint block holding fewer channels than the first;
* attention leaves keep JAX's layouts (projections ``(in, out)``,
  ``pos_emb`` and the layer norm's affine (H, W, C)); ``scale_augment`` and
  ``shift_augment`` are carried as they are.

A component missing from the tree is missing from the result, so a training
checkpoint's trainable subtree bridges too.  Stage-1 training trees keep
``u``: ``bridge_gan_params`` / ``unbridge_gan_params`` carry the generator
(a first-stage tree) and both discriminators both ways, ``u`` included.  A
flow distillation student is a flow tree (``bridge_flow``); a direct
student has its own pair (``bridge_direct`` / ``unbridge_direct``).  The
encoder trainers' trees (a tower wrapper with both halves, ``u`` kept, and
the image AE's patch discriminator) go both ways through ``bridge_wrapper``
/ ``unbridge_wrapper``.  ``unbridge_second_stage`` is
the inverse: the port's params (or any tree of that layout, an optimizer
moment with None at the integer leaves) back to JAX's layouts as numpy, steps
stacked and permutations int32, for ``ckpt/io.save``.
"""
from __future__ import annotations

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.ckpt.io import load
from ipoke_tpu_torch.nn import core

KERNELS = ("w", "v")
AUGMENT_KEYS = ("scale_augment", "shift_augment")


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


def _convert(tree, device, transposed=False, keep_u=False):
    """Leaves to tensors; conv kernels 'w'/'v' to the port's layouts; the
    spectral-norm vectors 'u' dropped unless ``keep_u``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "u" and not keep_u and "log_s" not in tree:   # conv-LU's u stays
                continue
            if k in KERNELS and not isinstance(v, (dict, list)) and np.ndim(v) in (4, 5):
                w = torch.from_numpy(np.array(v, dtype=np.float32))
                out[k] = core.from_hwio(w, transposed).to(device)
            else:
                out[k] = _convert(v, device, transposed, keep_u)
        return out
    if isinstance(tree, list):
        return [_convert(v, device, transposed, keep_u) for v in tree]
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _tree_of(tree):
    """``tree`` itself, or the tree of the npz at the path ``tree``."""
    if isinstance(tree, (str, bytes)) or hasattr(tree, "__fspath__"):
        tree, _ = load(tree)
    return tree


def _block_channels(block):
    steps = block["levels"][0]["steps"]
    steps = steps[0] if isinstance(steps, list) else steps   # the port's list, JAX's stack
    return np.shape(steps["actnorm1"]["log_scale"])[-1]


def _stack_grows(blocks):
    """An ``up`` stack: depth-to-space before the midpoint block leaves it
    fewer channels than the first block."""
    return _block_channels(blocks[len(blocks) // 2]) < _block_channels(blocks[0])


def bridge_flow(tree, device=None):
    """The JAX flow tree ({'levels': [...]}, or a stack's {'blocks': [...],
    'h_transforms': [...]}) -> the port's."""
    device = resolve_device(device)
    if "blocks" in tree:
        out = {"blocks": [bridge_flow(b, device) for b in tree["blocks"]]}
        if "h_transforms" in tree:
            grows = _stack_grows(tree["blocks"])
            out["h_transforms"] = [_convert(t, device, transposed=grows)
                                   for t in tree["h_transforms"]]
        return out
    levels = []
    for level in tree["levels"]:
        steps = level["steps"]
        levels.append({
            "steps": [_convert(_unstack(steps, i), device) for i in range(_n_stacked(steps))],
            "prior": _convert(level["prior"], device),
            "shuffle": _convert(level["shuffle"], device),
        })
    return {"levels": levels}


def _bridge_first_stage(fs, device, keep_u=False):
    gen = fs["gen"]
    conv = lambda t, transposed=False: _convert(t, device, transposed, keep_u)  # noqa: E731
    out = {
        "gen": {
            "in_block": conv(gen["in_block"]),
            # upsampling res blocks: res_conv and conv1 are transpose convs
            "blocks": [{k: conv(v, transposed=k != "conv2") for k, v in b.items()}
                       for b in gen["blocks"]],
            "spades": conv(gen["spades"]),
            "out_conv": conv(gen["out_conv"]),
        },
    }
    for key in ("enc_motion", "rnn", "motion_bias"):
        if key in fs:
            out[key] = conv(fs[key])
    return out


def _adapters(spec):
    """(name, grows) of each spatial-size adapter: a growing one is a
    transpose conv."""
    s = spec.first_stage.min_spatial_size
    return [(name, w.min_spatial_size < s) for name, w in
            (("conv_adapt_poke_emb", spec.poke_embedder), ("conv_adapt_cond", spec.conditioner))
            if w is not None]


def grown_adapters(spec):
    """The names of ``spec``'s size adapters that grow: transpose convs."""
    return [name for name, grows in _adapters(spec) if grows]


def bridge_second_stage(tree, spec, device=None):
    """The JAX second-stage tree (or the path of its npz) -> the port's params.

    ``spec`` is the port's SecondStageSpec; it says which size adapters grow
    (transpose conv) and which shrink.
    """
    return bridge_components(tree, grown_adapters(spec), device)


def bridge_components(tree, grown=(), device=None):
    """``bridge_second_stage`` with the growing size adapters named in
    ``grown`` instead of read from a spec (a serving artifact's manifest
    names them)."""
    device = resolve_device(device)
    tree = _tree_of(tree)
    out = {}
    if "flow" in tree:
        out["flow"] = bridge_flow(tree["flow"], device)
    if "first_stage" in tree:
        out["first_stage"] = _bridge_first_stage(tree["first_stage"], device)
    for name in ("poke_embedder", "conditioner"):
        if name in tree:
            out[name] = {"encoder": _convert(tree[name]["encoder"], device)}
    for name in ("conv_adapt_poke_emb", "conv_adapt_cond"):
        if name in tree:
            out[name] = _convert(tree[name], device, transposed=name in grown)
    for name in AUGMENT_KEYS:
        if name in tree:
            out[name] = _convert(tree[name], device)
    return out


# ---------------------------------------------------------------------------
# the inverse: the port's layouts -> the JAX package's, as numpy
# ---------------------------------------------------------------------------

def _export(tree, transposed=False):
    if isinstance(tree, dict):
        return {k: (np.ascontiguousarray(core.to_hwio(v, transposed).detach().cpu().numpy())
                    if k in KERNELS and isinstance(v, torch.Tensor) and v.dim() in (4, 5)
                    else _export(v, transposed))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_export(v, transposed) for v in tree]
    if tree is None:
        return None
    a = tree.detach().cpu().numpy()
    return a.astype(np.int32) if np.issubdtype(a.dtype, np.integer) else a


def _stack(trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stack([t[k] for t in trees]) for k in head}
    if isinstance(head, list):
        return [_stack([t[i] for t in trees]) for i in range(len(head))]
    return None if head is None else np.stack(trees)


def unbridge_flow(flow):
    if "blocks" in flow:
        out = {"blocks": [unbridge_flow(b) for b in flow["blocks"]]}
        if "h_transforms" in flow:
            grows = _stack_grows(flow["blocks"])
            out["h_transforms"] = [_export(t, transposed=grows) for t in flow["h_transforms"]]
        return out
    return {"levels": [{"steps": _stack([_export(s) for s in level["steps"]]),
                        "prior": _export(level["prior"]),
                        "shuffle": _export(level["shuffle"])} for level in flow["levels"]]}


def _unbridge_first_stage(fs):
    gen = fs["gen"]
    out = {k: _export(v) for k, v in fs.items() if k != "gen"}
    out["gen"] = {
        "in_block": _export(gen["in_block"]),
        "blocks": [{k: _export(v, transposed=k != "conv2") for k, v in b.items()}
                   for b in gen["blocks"]],
        "spades": _export(gen["spades"]),
        "out_conv": _export(gen["out_conv"]),
    }
    return out


def unbridge_second_stage(params, spec):
    """The port's params (any subset of the components) -> the JAX layouts."""
    out = {}
    if "flow" in params:
        out["flow"] = unbridge_flow(params["flow"])
    if "first_stage" in params:
        out["first_stage"] = _unbridge_first_stage(params["first_stage"])
    for name in ("poke_embedder", "conditioner"):
        if name in params:
            out[name] = {"encoder": _export(params[name]["encoder"])}
    for name, grows in _adapters(spec):
        if name in params:
            out[name] = _export(params[name], transposed=grows)
    for name in AUGMENT_KEYS:
        if name in params:
            out[name] = _export(params[name])
    return out


# ---------------------------------------------------------------------------
# distillation students
# ---------------------------------------------------------------------------

def bridge_direct(tree, device=None):
    """A direct student's JAX tree (or the path of its npz, e.g.
    ``bench_distill --save``) -> the port's params: conv kernels HWIO ->
    OIHW, the residual blocks a list."""
    return _convert(_tree_of(tree), resolve_device(device))


def unbridge_direct(params):
    """The inverse of ``bridge_direct``, as numpy for ``ckpt/io.save``."""
    return _export(params)


# ---------------------------------------------------------------------------
# stage-1 GAN training: generator, spatial and temporal discriminator
# ---------------------------------------------------------------------------

GAN_NETS = ("gen_params", "ds_params", "dt_params")


def bridge_gan_params(tree, device=None):
    """The nets of a JAX ``GanTrainState`` (or of its ``last.npz`` at the
    path ``tree``), ``u`` kept: those of 'gen_params', 'ds_params' and
    'dt_params' it holds, in the port's layouts (the 3D kernels DHWIO ->
    OIDHW)."""
    device = resolve_device(device)
    tree = _tree_of(tree)
    return {k: (_bridge_first_stage(tree[k], device, keep_u=True) if k == "gen_params"
                else _convert(tree[k], device, keep_u=True)) for k in GAN_NETS if k in tree}


def unbridge_gan_params(nets):
    """The inverse of ``bridge_gan_params`` (any of the three keys, or trees
    of that layout such as optimizer moments), as numpy for ``ckpt/io.save``."""
    return {k: (_unbridge_first_stage(v) if k == "gen_params" else _export(v))
            for k, v in nets.items()}


# ---------------------------------------------------------------------------
# the encoder trainers: a tower wrapper with both halves, ``u`` kept
# ---------------------------------------------------------------------------

def bridge_wrapper(tree, device=None, keep_u=True):
    """A JAX ``init_wrapper`` tree ({'encoder', 'decoder'}; or a tree of
    that layout such as an optimizer moment) -> the port's: the decoder's
    upsampling blocks hold conv1 and res_conv as transpose convs."""
    device = resolve_device(device)
    conv = lambda t, transposed=False: _convert(t, device, transposed, keep_u)  # noqa: E731
    out = {"encoder": conv(tree["encoder"])}
    if "decoder" in tree:
        dec = tree["decoder"]
        out["decoder"] = {
            "in_block": conv(dec["in_block"]),
            "blocks": [{k: conv(v, transposed=k != "conv2") for k, v in b.items()}
                       for b in dec["blocks"]],
            "out_conv": conv(dec["out_conv"]),
        }
    return out


def unbridge_wrapper(params):
    """The inverse of ``bridge_wrapper``, as numpy for ``ckpt/io.save``."""
    out = {"encoder": _export(params["encoder"])}
    if "decoder" in params:
        dec = params["decoder"]
        out["decoder"] = {
            "in_block": _export(dec["in_block"]),
            "blocks": [{k: _export(v, transposed=k != "conv2") for k, v in b.items()}
                       for b in dec["blocks"]],
            "out_conv": _export(dec["out_conv"]),
        }
    return out
