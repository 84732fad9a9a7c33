"""The port's optimizer state as optax's state tree, and back: the one home
of that layout, for every trainer's checkpoint.

The port's ``train/second_stage.Optimizer`` keeps a flat list of transform
states over the trainable float leaves; optax keeps a tree that JAX's
``ckpt/io.save`` flattens:

* a chain is a tuple of its transforms' states, a chain inside a chain a
  tuple inside it (``Optimizer.layout``): ``clip_by_global_norm`` in front
  of a chain nests that chain at position 1;
* ``add_decayed_weights``, ``clip_by_global_norm``, ``set_to_zero`` and a
  constant ``scale`` keep an empty state (``{}``; the npz keeps it as an
  ``__empty__`` key);
* ``scale_by_adam`` / ``scale_by_belief`` keep ``{count, mu, nu}`` (JAX's
  torch-amsgrad adds ``nu_max``), the moments in the params' tree (JAX's
  layout);
* ``scale_by_learning_rate`` of a schedule keeps ``{count}``;
* ``multi_transform`` (``Optimizer.masked``) wraps the chain as
  ``{inner_states: {train: {inner_state: <chain>}, freeze: {inner_state:
  {}}}}`` and puts an empty ``MaskedNode`` in each moment where a leaf is
  frozen (an integer leaf, a spectral-norm ``u``).

``to_optax`` writes that tree (numpy, int32 counts), ``from_optax`` reads it
back into the port's state; JAX's ``restore_like`` reads the first and
writes the second.  ``export`` / ``bridge`` move a tree between the port's
param layout and JAX's (``ckpt/jax_bridge``).
"""
from __future__ import annotations

import numpy as np
import torch

FROZEN_KEYS = ("u",)   # float leaves no optimizer trains: the spectral-norm vectors


def masked_like(params, values, masked=dict):
    """``params``' tree with its trainable float leaves replaced, in order, by
    ``values`` and every frozen leaf (integer, or under a ``FROZEN_KEYS``
    key) by ``masked()``: ``{}``, optax's ``MaskedNode``, unless another is
    asked for (``lambda: None`` keeps each frozen leaf's key in a flat
    view).  The layout an optimizer moment is saved in."""
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: (masked() if k in FROZEN_KEYS else walk(v)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it) if node.is_floating_point() else masked()

    return walk(params)


def take_like(params, tree):
    """The leaves of ``tree`` (the port's layout) at the trainable float
    leaves of ``params``, in their order.  A missing key raises KeyError, a
    leaf of another shape ValueError."""
    if isinstance(params, dict):
        return [t for k, v in params.items() if k not in FROZEN_KEYS
                for t in take_like(v, tree[k])]
    if isinstance(params, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(params):
            raise KeyError(f"a list of {len(params)} where the tree holds {type(tree).__name__}")
        return [t for v, sub in zip(params, tree) for t in take_like(v, sub)]
    if not params.is_floating_point():
        return []
    if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != tuple(params.shape):
        raise ValueError(f"a leaf of shape {getattr(tree, 'shape', type(tree))} where "
                         f"the params hold {tuple(params.shape)}")
    return [tree]


def _state_of(transform, state, moment):
    name = transform.name
    if name in ("clip", "decayed_weights"):
        return {}
    if name == "schedule":
        return {"count": np.asarray(state["count"], np.int32)} if transform.counted else {}
    out = {"count": np.asarray(state["count"], np.int32)}
    for k in ("mu", "nu", "nu_max"):
        if k in state:
            out[k] = moment(state[k])
    return out


def _nest(layout, states):
    if isinstance(layout, int):
        return states[layout]
    return [_nest(sub, states) for sub in layout]


def to_optax(optimizer, opt_state, params, export):
    """``opt_state`` (the port's, over the trainable float leaves of
    ``params``, the port's tree) as optax's state tree in JAX's layout;
    ``export`` maps a tree of ``params``' layout to JAX's as numpy."""
    moment = lambda values: export(masked_like(params, values))   # noqa: E731
    chain = _nest(optimizer.layout, [_state_of(t, s, moment)
                                     for t, s in zip(optimizer.transforms, opt_state)])
    if not optimizer.masked:
        return chain
    return {"inner_states": {"train": {"inner_state": chain}, "freeze": {"inner_state": {}}}}


def _pick(layout, tree, out):
    if isinstance(layout, int):
        out[layout] = tree
        return out
    seq = tree if isinstance(tree, (list, tuple)) else None
    if seq is None or len(seq) != len(layout):
        raise KeyError(f"a chain of {len(layout)} states where the tree holds {tree!r:.80}")
    for sub, node in zip(layout, seq):
        _pick(sub, node, out)
    return out


def from_optax(optimizer, tree, params, bridge):
    """The port's state of ``optimizer`` over the trainable float leaves of
    ``params`` from optax's state ``tree`` (JAX's npz, or ``to_optax``'s);
    ``bridge`` maps a tree of JAX's param layout to the port's tensors.  A
    tree of another chain raises KeyError; a moment of another shape
    ValueError.  A constant lr's count, which optax does not keep, is the
    first counted transform's."""
    if optimizer.masked:
        tree = tree["inner_states"]["train"]["inner_state"]
    picked = _pick(optimizer.layout, tree, {})
    states = []
    for i, t in enumerate(optimizer.transforms):
        node = picked[i]
        if t.name in ("clip", "decayed_weights"):
            states.append({})
        elif t.name == "schedule":
            states.append({"count": int(node["count"]) if t.counted else None})
        else:
            s = {"count": int(node["count"])}
            for k in ("mu", "nu") + (("nu_max",) if t.name == "amsgrad" else ()):
                s[k] = take_like(params, bridge(node[k]))
            states.append(s)
    counts = [s["count"] for s in states if s.get("count") is not None]
    for s in states:
        if "count" in s and s["count"] is None:
            s["count"] = counts[0] if counts else 0
    return states


def conform(template, tree):
    """``tree`` (the port's tensors) in ``template``'s key order, the order
    in which the optimizer walks the leaves (an npz of JAX's keeps its own).
    Raises KeyError where it has other keys or list lengths, ValueError where
    a leaf has another shape or is float where the template's is not, or
    the reverse."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or tree.keys() != template.keys():
            raise KeyError(f"keys {sorted(template)} where the tree holds "
                           f"{sorted(tree) if isinstance(tree, dict) else type(tree).__name__}")
        return {k: conform(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise KeyError(f"a list of {len(template)} where the tree holds {type(tree).__name__}")
        return [conform(v, sub) for v, sub in zip(template, tree)]
    if (not isinstance(tree, torch.Tensor) or tuple(tree.shape) != tuple(template.shape)
            or tree.is_floating_point() != template.is_floating_point()):
        raise ValueError(f"a leaf {getattr(tree, 'shape', type(tree))} where the template holds "
                         f"{tuple(template.shape)} {template.dtype}")
    return tree
