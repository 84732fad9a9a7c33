"""MaCow v1, the older unconditional flow family (counterpart of
``ipoke_tpu/flows/macow_v1.py``); no released checkpoint holds one
(``ckpt/torch_import.convert_macow_v1_step`` reads the reference's).

Against v2 (``flows/macow``):
  * transform: mu + sigmoid(raw_logscale + 2) * z;
  * MCF: a weight-normed shifted conv WITH bias; the conditioning s is
    ADDED to the hidden after a 3x3 ``s_conv``;
  * unit order: ActNorm -> MCF(A) -> MCF(B) -> ActNorm -> MCF(C) -> MCF(D);
  * step: units x N, then a Glow step (ActNorm -> Shuffle -> NICE with the
    sigmoid scale).

An MCF's inverse solves one row (order A; the other orders are flips and
transposes of it) at a time from the rows already solved, a loop over the
rows as JAX's ``lax.scan``.  No kernel computes it: K1 and K2 invert v2's
affine MCF.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.flows import actnorm, permute
from ipoke_tpu_torch.flows.convnets import init_wn_conv, shifted_conv_apply, wn_conv_apply
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.core import conv2d
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class MaCowV1Spec:
    in_channels: int
    hidden_channels: int
    kernel_size: tuple = (2, 3)
    s_channels: int = 0
    num_units: int = 2
    scale: bool = True


def _sigmoid_scale(raw):
    return torch.sigmoid(raw + 2.0)


def _sum_log(scale):
    return torch.log(scale).reshape(scale.shape[0], -1).float().sum(dim=1)


# -- v1 MCF -----------------------------------------------------------------

def init_mcf_v1(key, c, kernel, spec: MaCowV1Spec, device="cpu"):
    k1, k2, k3 = prng.split(key, 3)
    kh, kw = kernel
    out_c = c * (2 if spec.scale else 1)
    wn = lambda k, a, b, ci, co: init_wn_conv(k, a, b, ci, co, device, zero_init=False)  # noqa: E731
    p = {"shift_conv": wn(k1, kh, kw, c, spec.hidden_channels),
         "conv1x1": wn(k2, 1, 1, spec.hidden_channels, out_c)}
    if spec.s_channels > 0:
        p["s_conv"] = wn(k3, 3, 3, spec.s_channels, spec.hidden_channels)
    return p


def _shift_w(p):
    return core.weight_norm_materialize(p["shift_conv"]["v"], p["shift_conv"]["g"])


def _split_scale(raw, spec):
    if spec.scale:
        mu, logs = raw.chunk(2, dim=-1)
        return mu, _sigmoid_scale(logs)
    return raw, None


def _s_hidden(p, s):
    return None if s is None or "s_conv" not in p else wn_conv_apply(p["s_conv"], s, padding=1)


def mcf_v1_forward(p, x, s, order, spec: MaCowV1Spec):
    hidden = shifted_conv_apply({"w": _shift_w(p)}, x, order) + p["shift_conv"]["b"]
    sh = _s_hidden(p, s)
    if sh is not None:
        hidden = hidden + sh
    mu, scale = _split_scale(wn_conv_apply(p["conv1x1"], F.elu(hidden)), spec)
    if scale is None:
        return x + mu, torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    return x * scale + mu, _sum_log(scale)


def _canonicalize(w, z, sh, order):
    """Order ``order``'s kernel (OIHW) and maps as order A's, with the map
    that undoes it on the result."""
    same = lambda a: a  # noqa: E731
    if order == "A":
        return w, z, sh, same
    if order == "B":
        flip = lambda a: a.flip(1)  # noqa: E731
        return w.flip(2), flip(z), None if sh is None else flip(sh), flip
    if order == "C":
        swap = lambda a: a.transpose(1, 2)  # noqa: E731
        return w.transpose(2, 3), swap(z), None if sh is None else swap(sh), swap
    fwd = lambda a: a.transpose(1, 2).flip(1)  # noqa: E731
    return (w.transpose(2, 3).flip(2), fwd(z), None if sh is None else fwd(sh),
            lambda a: a.flip(1).transpose(1, 2))


def mcf_v1_inverse(p, z, s, order, spec: MaCowV1Spec):
    """The rows solved one after the other, each from the window of the kh
    rows above it (order A after ``_canonicalize``)."""
    w, z_c, sh_c, undo = _canonicalize(_shift_w(p), z, _s_hidden(p, s), order)
    b, height, width, c = z_c.shape
    kh, kw = w.shape[2], w.shape[3]
    cw = (kw - 1) // 2
    wn = p["conv1x1"]
    w1x1 = core.weight_norm_materialize(wn["v"], wn["g"])[:, :, 0, 0].T.to(z.dtype)
    w, bias = w.to(z.dtype), p["shift_conv"]["b"].to(z.dtype)
    win = z.new_zeros((b, c, kh, width + 2 * cw))          # NCHW: the kh rows above
    rows = []
    for i in range(height):
        ctx = F.conv2d(win, w)[:, :, 0].transpose(1, 2) + bias   # (B, W, hidden)
        if sh_c is not None:
            ctx = ctx + sh_c[:, i]
        raw = F.elu(ctx) @ w1x1 + wn["b"].to(z.dtype)
        mu, scale = _split_scale(raw, spec)
        row = z_c[:, i] - mu if scale is None else (z_c[:, i] - mu) / (scale + 1e-12)
        rows.append(row)
        padded = F.pad(row.transpose(1, 2), (cw, cw))[:, :, None]
        win = torch.cat([win[:, :, 1:], padded], dim=2)
    return undo(torch.stack(rows, dim=1))


# -- v1 MaCowUnit -----------------------------------------------------------

def init_unit_v1(key, spec: MaCowV1Spec, device="cpu"):
    ks = prng.split(key, 6)
    kh, kw = spec.kernel_size
    c = spec.in_channels
    return {"actnorm1": actnorm.init_actnorm(ks[0], c, device),
            "conv1": init_mcf_v1(ks[1], c, (kh, kw), spec, device),
            "conv2": init_mcf_v1(ks[2], c, (kh, kw), spec, device),
            "actnorm2": actnorm.init_actnorm(ks[3], c, device),
            "conv3": init_mcf_v1(ks[4], c, (kw, kh), spec, device),
            "conv4": init_mcf_v1(ks[5], c, (kw, kh), spec, device)}


def unit_v1_forward(p, x, s, spec):
    out, ld = actnorm.forward(p["actnorm1"], x)
    for name, order in (("conv1", "A"), ("conv2", "B")):
        out, l_ = mcf_v1_forward(p[name], out, s, order, spec)
        ld = ld + l_
    out, l_ = actnorm.forward(p["actnorm2"], out)
    ld = ld + l_
    for name, order in (("conv3", "C"), ("conv4", "D")):
        out, l_ = mcf_v1_forward(p[name], out, s, order, spec)
        ld = ld + l_
    return out, ld


def unit_v1_inverse(p, y, s, spec):
    out = mcf_v1_inverse(p["conv4"], y, s, "D", spec)
    out = mcf_v1_inverse(p["conv3"], out, s, "C", spec)
    out = actnorm.inverse(p["actnorm2"], out)
    out = mcf_v1_inverse(p["conv2"], out, s, "B", spec)
    out = mcf_v1_inverse(p["conv1"], out, s, "A", spec)
    return actnorm.inverse(p["actnorm1"], out)


# -- Glow step (ActNorm -> Shuffle -> v1 NICE) ------------------------------

def init_glow_step(key, spec: MaCowV1Spec, device="cpu"):
    """The v1 NICE subnet: WN 3x3 -> ELU -> WN 1x1 -> ELU -> a plain 3x3 conv
    of zeros (the reference's zero-init conv has no weight norm)."""
    ks = prng.split(key, 5)
    c, hid = spec.in_channels, spec.hidden_channels
    z1 = c - c // 2
    out_c = (c // 2) * (2 if spec.scale else 1)
    return {"actnorm": actnorm.init_actnorm(ks[0], c, device),
            "shuffle": permute.init_shuffle(ks[1], c, device),
            "nice": {"conv1": init_wn_conv(ks[2], 3, 3, z1, hid, device, zero_init=False),
                     "conv2": init_wn_conv(ks[3], 1, 1, hid, hid, device, zero_init=False),
                     "conv3": {"w": torch.zeros((out_c, hid, 3, 3), device=device),
                               "b": torch.zeros(out_c, device=device)}}}


def _nice_v1_params(p, z1, spec):
    h = F.elu(wn_conv_apply(p["conv1"], z1, padding=1))
    h = F.elu(wn_conv_apply(p["conv2"], h))
    return _split_scale(conv2d(h, p["conv3"]["w"], p["conv3"]["b"], padding=1), spec)


def glow_step_forward(p, x, spec):
    z1c = spec.in_channels - spec.in_channels // 2
    out, ld = actnorm.forward(p["actnorm"], x)
    out, _ = permute.shuffle_forward(p["shuffle"], out)
    z1, z2 = out[..., :z1c], out[..., z1c:]
    mu, scale = _nice_v1_params(p["nice"], z1, spec)
    if scale is not None:
        z2 = z2 * scale
        ld = ld + _sum_log(scale)
    return torch.cat([z1, z2 + mu], dim=-1), ld


def glow_step_inverse(p, y, spec):
    z1c = spec.in_channels - spec.in_channels // 2
    z1, z2 = y[..., :z1c], y[..., z1c:]
    mu, scale = _nice_v1_params(p["nice"], z1, spec)
    z2 = z2 - mu
    if scale is not None:
        z2 = z2 / (scale + 1e-12)
    out = permute.shuffle_inverse(p["shuffle"], torch.cat([z1, z2], dim=-1))
    return actnorm.inverse(p["actnorm"], out)


# -- v1 MaCowStep -----------------------------------------------------------

def init_step_v1(key, spec: MaCowV1Spec, device="cpu"):
    return {"units": [init_unit_v1(prng.fold_in(key, i), spec, device)
                      for i in range(spec.num_units)],
            "glow": init_glow_step(prng.fold_in(key, 100), spec, device)}


def step_v1_forward(p, x, spec, s=None):
    ld = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    out = x
    for u in p["units"]:
        out, l_ = unit_v1_forward(u, out, s, spec)
        ld = ld + l_
    out, l_ = glow_step_forward(p["glow"], out, spec)
    return out, ld + l_


def step_v1_inverse(p, y, spec, s=None):
    out = glow_step_inverse(p["glow"], y, spec)
    for u in reversed(p["units"]):
        out = unit_v1_inverse(u, out, s, spec)
    return out
