"""Sequence (time-axis) parallelism for the 3D-ResNet motion encoder
(counterpart of ``ipoke_tpu/parallel/seqpar.py``).

A long video's time axis is split over the ``seq`` axis of the mesh: each
rank holds its block of frames (and, with a batch axis, its rows), and runs
``models/motion_encoder.apply`` with three communication-aware ops:

* **halo conv**: a temporal kernel-3 conv takes one frame from each
  neighbouring shard at temporal stride 1, the left one only at stride 2 (the
  last stride-2 window ends on the shard's own final frame).  The shards at
  the ends of the sequence get zeros, which is the dense conv's zero
  padding, so the sharded conv is the dense one.  The frames come from an
  all-gather of every shard's two edge frames (``parallel/distributed.halo``);
* **GroupNorm of global moments**: the encoder's GroupNorm reduces over (T,
  H, W, group channels), so the moments are summed over the shards, the sum
  first and then the squared deviations from the global mean (two passes,
  as ``jnp.var``);
* **cross-shard temporal mean** in place of the dense squeeze-or-mean.

Gradients flow through all three.  Every all-reduce here transposes to an
all-reduce, so each rank's gradient of a replicated parameter is ``n`` times
its share: the gradient of the whole is the mean over the ``seq`` ranks of
their gradients (then the sum or mean over the batch axis, as the loss sums
or averages the batch).

Shape contract: with ``n`` seq shards the local time length must stay even
at every temporal stride-2 conv, i.e. ``T % (n * 2**n_tstrides) == 0``
(:func:`check_plan`).  Short clips use the dense path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ipoke_tpu_torch.models import motion_encoder
from ipoke_tpu_torch.models.motion_encoder import MotionEncoderSpec
from ipoke_tpu_torch.nn.core import conv3d
from ipoke_tpu_torch.parallel import distributed
from ipoke_tpu_torch.parallel.mesh import axis_index, axis_size, group
from ipoke_tpu_torch.utils import prng


# ---------------------------------------------------------------------------
# temporal-stride plan
# ---------------------------------------------------------------------------

def temporal_strides(spec: MotionEncoderSpec):
    """Temporal stride of every stage's first conv, in order (stem first)."""
    _, stride1, stride4, has_l4, has_l5, _ = spec.derived()
    st = [2, stride1[0], 2, 2]  # stem, layer1, layer2, layer3
    if has_l4:
        st.append(stride4[0])
    if has_l5:
        st.append(2)
    return st


def check_plan(spec: MotionEncoderSpec, t: int, n_seq: int):
    """Raise with an actionable message unless (t, n_seq) shards cleanly;
    returns the local time length after the last stride-2 stage."""
    if t % n_seq:
        raise ValueError(f"T={t} not divisible by n_seq={n_seq}")
    t_local = t // n_seq
    for i, s in enumerate(temporal_strides(spec)):
        if s == 2:
            if t_local < 2 or t_local % 2:
                need = n_seq * 2 ** sum(1 for x in temporal_strides(spec) if x == 2)
                raise ValueError(
                    f"local time length {t_local} at temporal-stride stage {i} "
                    f"is not an even >=2 number; need T to be a multiple of "
                    f"{need} for n_seq={n_seq} (long-video regime), got T={t}"
                )
            t_local //= 2
    return t_local


def shortest_length(spec: MotionEncoderSpec, n_seq: int) -> int:
    """The shortest video ``check_plan`` admits on ``n_seq`` shards."""
    return n_seq * 2 ** sum(1 for x in temporal_strides(spec) if x == 2)


# ---------------------------------------------------------------------------
# communication-aware ops
# ---------------------------------------------------------------------------

def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _halo_conv3d(grp):
    """``conv3d`` whose temporal receptive field crosses shard borders."""

    def conv_fn(x, w, stride=1, padding=0):
        st, pad = _triple(stride), _triple(padding)
        kt = int(w.shape[2])                      # OIDHW
        if kt == 1:
            if pad[0]:
                raise ValueError("a kernel-1 temporal conv with temporal padding")
            return conv3d(x, w, stride=st, padding=(0, pad[1], pad[2]))
        if kt != 3 or pad[0] != 1 or st[0] not in (1, 2):
            raise ValueError(f"no halo plan for temporal kernel {kt}, pad {pad}, stride {st}")
        left, right = distributed.halo(x, grp)
        parts = [left.to(x.dtype), x]
        if st[0] == 1:
            parts.append(right.to(x.dtype))
        elif x.shape[1] % 2:
            raise ValueError(f"odd local T {x.shape[1]} at temporal stride 2")
        return conv3d(torch.cat(parts, dim=1), w, stride=st, padding=(0, pad[1], pad[2]))

    return conv_fn


def _seq_group_norm(grp, n):
    """GroupNorm with its moments summed over the sharded time axis."""

    def gn_fn(x, gamma=None, beta=None, num_groups=16, eps=1e-5):
        c = x.shape[-1]
        if c % num_groups:
            raise ValueError(f"channels {c} not divisible by groups {num_groups}")
        xg = x.reshape(tuple(x.shape[:-1]) + (num_groups, c // num_groups))
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)   # (T, H, W, c/g)
        cnt = float(math.prod(xg.shape[a] for a in axes) * n)
        mean = distributed.all_reduce(xg.sum(dim=axes, keepdim=True), grp) / cnt
        var = distributed.all_reduce(((xg - mean) ** 2).sum(dim=axes, keepdim=True), grp) / cnt
        y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
        if gamma is not None:
            y = y * gamma.to(y.dtype)
        if beta is not None:
            y = y + beta.to(y.dtype)
        return y

    return gn_fn


def _seq_t_reduce(grp, n):
    """The temporal mean over every shard."""

    def t_reduce(out):
        return distributed.all_reduce(out.sum(dim=1), grp) / (out.shape[1] * n)

    return t_reduce


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def local_block(mesh, x, seq_axis: str = "seq", batch_axis: Optional[str] = None):
    """This rank's block of a video ``x`` (B, T, H, W, 3): the frames of its
    index on ``seq_axis`` and, with ``batch_axis``, the rows of its index
    there."""
    n, i = axis_size(mesh, seq_axis), axis_index(mesh, seq_axis)
    t = x.shape[1] // n
    x = x[:, i * t:(i + 1) * t]
    if batch_axis is not None:
        m, j = axis_size(mesh, batch_axis), axis_index(mesh, batch_axis)
        b = x.shape[0] // m
        x = x[j * b:(j + 1) * b]
    return x


def encode(params, x, spec: MotionEncoderSpec, mesh, seq_axis: str = "seq",
           batch_axis: Optional[str] = None, rng=None):
    """Sequence-parallel motion encode of this rank's block ``x`` (its
    frames of a video whose time axis is split over ``seq_axis``, and its
    rows when ``batch_axis`` splits the batch; :func:`local_block`).
    Returns (z, mu, logvar) of its rows, the same on every rank of
    ``seq_axis``: ``models/motion_encoder.apply`` of the whole video up to
    f32 reduction order.

    With a sampling key and a batch axis, the key is folded with the rank's
    index there (each batch shard draws its own eps); the ranks of
    ``seq_axis`` keep the same key, since their mu/logvar are the same."""
    n = axis_size(mesh, seq_axis)
    check_plan(spec, x.shape[1] * n, n)
    grp = group(mesh, seq_axis)
    if rng is not None and batch_axis is not None:
        rng = prng.fold_in(rng, axis_index(mesh, batch_axis))
    return motion_encoder.apply(params, x, spec, rng=rng, conv_fn=_halo_conv3d(grp),
                                gn_fn=_seq_group_norm(grp, n), t_reduce=_seq_t_reduce(grp, n))
