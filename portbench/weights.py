"""The benchmark's weights: parameter trees in the port's layout (OIHW /
OIDHW convs, ``(in, out, kh, kw)`` transpose convs, one tree per MaCowStep),
filled on the device from the seed in a few large draws.

Every float leaf is a view into one N(0, 1) draw scaled by ``weight_std``;
norm gains (``gamma``) are 1 and their shifts (``beta``) 0, as a fresh model
holds them; a spectral-norm vector ``u`` is a unit vector; the flow's
output convs (each MCF's 1x1 conv, each NICE coupling's last conv) get the
gain ``flow_output_gain`` and a zero bias, so that every coupling does work
and the 50-step reverse stays finite.  A shuffle holds a random permutation
and its inverse.  These scales are the configuration file's ``assumed``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.sample import level_channels, level_factors, mcf_hidden, nice_split


class Leaf:
    """A tensor to make: ``kind`` 'normal' (scaled by ``std`` where given),
    'ones', 'zeros', 'unit', 'gain', or 'perm' (a permutation of ``shape[0]``)."""

    def __init__(self, shape, kind="normal", std=None):
        self.shape, self.kind, self.std = tuple(shape), kind, std


def _f(*shape):
    return Leaf(shape)


def _norm(c):
    return {"gamma": Leaf((c,), "ones"), "beta": Leaf((c,), "zeros")}


def _conv(c_out, c_in, k, bias=True, transposed=False, snorm=False):
    p = {"w": _f(c_in, c_out, k, k) if transposed else _f(c_out, c_in, k, k)}
    if bias:
        p["b"] = _f(c_out)
    if snorm:
        p["u"] = Leaf((c_out,), "unit")
    return p


def _conv_block(c_in, c_out, norm="none", transposed=False, snorm=False):
    p = {"conv": _conv(c_out, c_in, 3, transposed=transposed, snorm=snorm)}
    if norm == "group":
        p["norm"] = _norm(c_out)
    return p


def _res_block(c_in, c_out, norm, upsampling=False, stride=1, snorm=False):
    p = {"conv1": _conv_block(c_in, c_out, norm, transposed=upsampling, snorm=snorm),
         "conv2": _conv_block(c_out, c_out, norm, snorm=snorm)}
    if c_in != c_out or upsampling or stride != 1:
        p["res_conv"] = _conv_block(c_in, c_out, transposed=upsampling, snorm=snorm)
    return p


# --- the second stage --------------------------------------------------------

def _out_conv(c_in, c_out, k):
    return {"v": _f(c_out, c_in, k, k), "g": Leaf((c_out,), "gain"), "b": Leaf((c_out,), "zeros")}


def _actnorm(c):
    return {"log_scale": _f(c), "bias": _f(c)}


def _perm(c):
    return {"fwd_idx": Leaf((c,), "perm"), "inv_idx": None}


def _mcf(c, kernel, hc):
    hid = mcf_hidden(c)
    return {"net": {"shift_conv": {"w": _f(hid, c, *kernel)}, "conv1x1": _out_conv(hid + hc, 2 * c, 1)}}


def _unit(c, hc, k):
    kh, kw = k
    return {"conv1": _mcf(c, (kh, kw), hc), "conv2": _mcf(c, (kh, kw), hc), "actnorm1": _actnorm(c),
            "conv3": _mcf(c, (kw, kh), hc), "conv4": _mcf(c, (kw, kh), hc), "actnorm2": _actnorm(c)}


def _nice(c, hid, factor=2):
    """A NICE coupling's net: it reads the c - c // factor channels of one
    side and gives the affine params of the other side's c // factor."""
    net_in = c - c // factor
    return {"net": {"conv1": {"w": _f(hid, net_in, 3, 3)}, "conv2": {"w": _f(hid, hid, 1, 1)},
                    "conv3": _out_conv(hid, 2 * (c // factor), 3)}}


def _step(c, hid, hc, k):
    return {"actnorm1": _actnorm(c), "conv1x1": _perm(c),
            "units1": [_unit(c, hc, k), _unit(c, hc, k)],
            "coupling1_up": _nice(c, hid),
            "coupling1_dn": _nice(c, hid),
            "actnorm2": _actnorm(c),
            "units2": [_unit(c, hc, k), _unit(c, hc, k)],
            "coupling2_up": _nice(c, hid),
            "coupling2_dn": _nice(c, hid)}


def _tower(nf_in, nf_max, n_stages, variational):
    nf, p = 32, {"stem": _conv_block(nf_in, 32, "group"), "blocks": []}
    for _ in range(n_stages - 1):
        nf_out = min(nf * 2, nf_max)
        p["blocks"].append(_res_block(nf, nf_out, "group", stride=2))
        nf = nf_out
    p["bottleneck"] = _res_block(nf, nf_max, "group")
    if variational:
        for head in ("make_mu", "make_sigma"):
            p[head] = {"v": _f(nf_max, nf_max, 3, 3), "g": Leaf((nf_max,), "ones"), "b": _f(nf_max),
                       "gamma": Leaf((1, 1, 1, nf_max), "ones"), "beta": Leaf((1, 1, 1, nf_max), "zeros")}
    return {"encoder": p}


def _motion_encoder(fs):
    from portbench.reference.first_stage import encoder_plan
    channels, stride1, stride4, has_l4, has_l5, last = encoder_plan(fs)

    def block(c_in, c_out, down):
        p = {"conv1": {"w": _f(c_out, c_in, 3, 3, 3)}, "gn1": _norm(c_out),
             "conv2": {"w": _f(c_out, c_out, 3, 3, 3)}, "gn2": _norm(c_out)}
        if down or c_in != c_out:
            p["down"] = {"w": _f(c_out, c_in, 1, 1, 1), "gn": _norm(c_out)}
        return p

    def layer(i, stride):
        c_in, c_out = channels[i - 1], channels[i]
        return [block(c_in, c_out, stride != (1, 1, 1))] + [block(c_out, c_out, False)]

    p = {"conv1": {"w": _f(channels[0], 3, 3, 7, 7)}, "gn1": _norm(channels[0]),
         "layer1": layer(1, stride1), "layer2": layer(2, (2, 2, 2)), "layer3": layer(3, (2, 2, 2)),
         "conv_mu": _conv(fs["z_dim"], last, 3), "conv_var": _conv(fs["z_dim"], last, 3)}
    if has_l4:
        p["layer4"] = layer(4, stride4)
    if has_l5:
        p["layer5"] = layer(5, (2, 2, 2))
    return p


def first_stage_tree(fs, snorm=False):
    """The first stage: motion encoder, GRU stack, SPADE decoder (with ``u``
    on the decoder's res blocks when ``snorm``: training)."""
    z, ch = fs["z_dim"], fs["dec_channels"]
    gate = lambda: _conv(z, 2 * z, 3)  # noqa: E731
    return {
        "enc_motion": _motion_encoder(fs),
        "rnn": [{"reset": gate(), "update": gate(), "out": gate()} for _ in range(fs["n_gru_layers"])],
        "gen": {
            "in_block": _res_block(z, ch[0], "group", snorm=snorm),
            "blocks": [_res_block(ch[i], ch[i + 1], "none", upsampling=True, snorm=snorm)
                       for i in range(len(ch) - 1)],
            "spades": [{"conv": _conv(128, 3, 3), "conv_gamma": _conv(nf, 128, 3),
                        "conv_beta": _conv(nf, 128, 3)} for nf in ch[1:]],
            "out_conv": _conv_block(ch[-1], 3),
        },
        "motion_bias": _f(1, fs["min_spatial_size"], fs["min_spatial_size"], z),
    }


def second_stage_tree(cfg):
    """The sampling path's params of the configuration ``cfg``."""
    fs, fl = cfg["first_stage"], cfg["flow"]
    hc = cfg["poke_embedder"]["nf_max"] + cfg["conditioner"]["nf_max"]
    hid = fl["flow_mid_channels_factor"] * fs["z_dim"]
    k = tuple(fl["kernel_size"])
    n_stages = int(math.log2(fs["spatial_size"] // fs["min_spatial_size"]))
    levels = []
    for c, f, n in zip(level_channels(cfg), level_factors(cfg), fl["num_steps"]):
        _, z1c = nice_split(c, f, "continuous", "up")
        levels.append({"steps": [_step(c, hid, hc, k) for _ in range(n)],
                       "prior": {"conv1x1": _perm(c), "coupling": _nice(c, hid, f),
                                 "actnorm": _actnorm(c - z1c)},
                       "shuffle": _perm(c)})
    return {"flow": {"levels": levels}, "first_stage": first_stage_tree(fs),
            "poke_embedder": _tower(cfg["poke_embedder"]["nf_in"], cfg["poke_embedder"]["nf_max"],
                                    n_stages, False),
            "conditioner": _tower(cfg["conditioner"]["nf_in"], cfg["conditioner"]["nf_max"],
                                  n_stages, True)}


# --- the stage-1 GAN ---------------------------------------------------------

def patch_disc_tree(ndf=64, n_layers=3):
    mults = [min(2 ** n, 8) for n in range(n_layers + 1)]
    conv = lambda c_in, c_out: _conv(c_out, c_in, 4, snorm=True)  # noqa: E731
    return {"in_conv": conv(3, ndf),
            "layers": [conv(ndf * mults[n - 1], ndf * mults[n]) for n in range(1, n_layers + 1)],
            "out_conv": conv(ndf * mults[-1], 1)}


def temp_disc_tree():
    def conv(c_in, c_out, k=3):
        return {"w": _f(c_out, c_in, k, k, k), "u": Leaf((c_out,), "unit")}

    def block(c_in, c_out, down):
        p = {"conv1": conv(c_in, c_out), "gn1": _norm(c_out), "conv2": conv(c_out, c_out),
             "gn2": _norm(c_out)}
        if down:
            p["down"] = conv(c_in, c_out)
            p["down_gn"] = _norm(c_out)
        return p

    def layer(c_in, c_out, down):
        return [block(c_in, c_out, down), block(c_out, c_out, False)]

    return {"conv1": {"w": _f(64, 3, 3, 7, 7), "u": Leaf((64,), "unit")}, "gn1": _norm(64),
            "layer1": layer(64, 64, False), "layer2": layer(64, 128, True),
            "layer3": layer(128, 256, True), "layer4": layer(256, 512, True),
            "fc": {"w": Leaf((512, 1), std=0.02)}}


def gan_trees(cfg):
    return {"gen": first_stage_tree(cfg["first_stage"], snorm=True), "ds": patch_disc_tree(),
            "dt": temp_disc_tree()}


# --- filling -------------------------------------------------------------------

CONSTANT = {"ones": 1.0, "zeros": 0.0, "gain": None}


def _walk(tree, out):
    if isinstance(tree, Leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _walk(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _walk(v, out)


def _std(leaf, weight_std):
    """A normal leaf's scale: ``weight_std``, or with ``"fan_in"`` torch's
    default init scale 1/sqrt(3 fan_in) for a kernel (fan_in the product of
    its dims after the first, as torch counts it) and 0 for a bias; a leaf's
    own ``std`` before either."""
    if leaf.std is not None:
        return leaf.std
    if weight_std != "fan_in":
        return weight_std
    return 0.0 if len(leaf.shape) == 1 else 1.0 / math.sqrt(3 * math.prod(leaf.shape[1:]))


def make(tree, gen, device, weight_std, gain):
    """``tree`` with every ``Leaf`` made on ``device`` from ``gen``: one
    normal draw for all float leaves, one uniform draw per permutation width."""
    leaves = []
    _walk(tree, leaves)
    floats = [l for l in leaves if l.kind != "perm"]
    sizes = [math.prod(l.shape) for l in floats]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = [_std(l, weight_std) if l.kind == "normal" else 1.0 for l in floats]
    flat.mul_(torch.repeat_interleave(torch.tensor(scale, device=device),
                                      torch.tensor(sizes, device=device)))
    made, at, const_idx, const_val = {}, 0, [], []
    for leaf in floats:
        n = math.prod(leaf.shape)
        made[id(leaf)] = flat[at:at + n].view(leaf.shape)
        if leaf.kind in CONSTANT:
            const_idx.append(np.arange(at, at + n))
            const_val.append(np.full(n, CONSTANT[leaf.kind] if leaf.kind != "gain" else gain,
                                     np.float32))
        at += n
    if const_idx:   # every constant leaf in one scatter
        flat[torch.from_numpy(np.concatenate(const_idx)).to(device)] = \
            torch.from_numpy(np.concatenate(const_val)).to(device)
    units = [l for l in floats if l.kind == "unit"]
    for leaf in units:
        made[id(leaf)].div_(torch.linalg.vector_norm(made[id(leaf)]) + 1e-12)
    for width in sorted({l.shape[0] for l in leaves if l.kind == "perm"}):
        group = [l for l in leaves if l.kind == "perm" and l.shape[0] == width]
        idx = torch.rand((len(group), width), generator=gen, device=device).argsort(dim=1)
        for i, leaf in enumerate(group):
            made[id(leaf)] = idx[i]

    def build(node):
        if isinstance(node, Leaf):
            return made[id(node)]
        if isinstance(node, list):
            return [build(v) for v in node]
        out = {k: build(v) for k, v in node.items() if v is not None}
        if "fwd_idx" in out:
            out["inv_idx"] = torch.argsort(out["fwd_idx"])
        return out

    return build(tree)


def count(tree):
    leaves = []
    _walk(tree, leaves)
    return sum(math.prod(l.shape) for l in leaves)
