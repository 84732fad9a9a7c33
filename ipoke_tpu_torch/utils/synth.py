"""Parameter synthesis for timing and smoke runs (counterpart of
``ipoke_tpu/utils/synth.py``).

``param_shapes(spec)`` gives the port's second-stage parameter tree for the
sampling path (layouts as the bridge produces them: OIHW convs, ``(in, out,
kh, kw)`` transpose convs, one tree per MaCowStep), with each leaf a
``Leaf(kind, shape)``.  ``synth_params`` fills it on the device from a seeded
``torch.Generator``: float leaves N(0, 0.05), permutation leaves a valid
random permutation each, as the JAX package's ``synth_params`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.flows import mcf
from ipoke_tpu_torch.flows.nice import nice_channels


class Leaf(NamedTuple):
    kind: str            # 'float' | 'perm'
    shape: Tuple[int, ...]


def _f(*shape):
    return Leaf("float", tuple(shape))


def _perm(c):
    return {"fwd_idx": Leaf("perm", (c,)), "inv_idx": Leaf("perm", (c,))}


def _actnorm(c):
    return {"log_scale": _f(c), "bias": _f(c)}


def _wn_conv(c_in, c_out, k):
    return {"v": _f(c_out, c_in, k, k), "g": _f(c_out), "b": _f(c_out)}


def _conv_block(c_in, c_out, ks=3, norm="none", transposed=False):
    w = _f(c_in, c_out, ks, ks) if transposed else _f(c_out, c_in, ks, ks)
    p = {"conv": {"w": w, "b": _f(c_out)}}
    if norm == "group":
        p["norm"] = {"gamma": _f(c_out), "beta": _f(c_out)}
    return p


def _res_block(c_in, c_out, norm, upsampling=False, stride=1):
    p = {"conv1": _conv_block(c_in, c_out, norm=norm, transposed=upsampling),
         "conv2": _conv_block(c_out, c_out, norm=norm)}
    if c_in != c_out or upsampling or stride != 1:
        p["res_conv"] = _conv_block(c_in, c_out, transposed=upsampling)
    return p


# --- flow -------------------------------------------------------------------

def _mcf(c, kernel, hc):
    hid = mcf.default_hidden(c)
    return {"net": {"shift_conv": {"w": _f(hid, c, *kernel)},
                    "conv1x1": _wn_conv(hid + hc, 2 * c, 1)}}


def _unit(c, spec):
    kh, kw = spec.kernel_size
    hc = spec.h_channels
    return {"conv1": _mcf(c, (kh, kw), hc), "conv2": _mcf(c, (kh, kw), hc),
            "actnorm1": _actnorm(c),
            "conv3": _mcf(c, (kw, kh), hc), "conv4": _mcf(c, (kw, kh), hc),
            "actnorm2": _actnorm(c)}


def _nice(c, hidden, split, order, factor=2):
    _, _, net_in, out_base = nice_channels(c, factor, split, order)
    return {"net": {"conv1": {"w": _f(hidden, net_in, 3, 3)},
                    "conv2": {"w": _f(hidden, hidden, 1, 1)},
                    "conv3": _wn_conv(hidden, 2 * out_base, 3)}}


def _step(c, spec):
    hid = spec.hidden_channels
    return {
        "actnorm1": _actnorm(c), "conv1x1": _perm(c),
        "units1": [_unit(c, spec), _unit(c, spec)],
        "coupling1_up": _nice(c, hid, "continuous", "up"),
        "coupling1_dn": _nice(c, hid, "continuous", "down"),
        "actnorm2": _actnorm(c),
        "units2": [_unit(c, spec), _unit(c, spec)],
        "coupling2_up": _nice(c, hid, "skip", "up"),
        "coupling2_dn": _nice(c, hid, "skip", "down"),
    }


def flow_shapes(spec):
    levels = []
    for c, f, n in zip(spec.level_channels(), spec.level_factors(), spec.num_steps):
        _, z1c, _, _ = nice_channels(c, f, "continuous", "up")
        levels.append({
            "steps": [_step(c, spec) for _ in range(n)],
            "prior": {"conv1x1": _perm(c),
                      "coupling": _nice(c, spec.hidden_channels, "continuous", "up", f),
                      "actnorm": _actnorm(c - z1c)},
            "shuffle": _perm(c),
        })
    return {"levels": levels}


# --- towers and first stage ---------------------------------------------------

def _encoder(wspec):
    spec = wspec.encoder_spec
    nf = 32
    p = {"stem": _conv_block(spec.nf_in, nf, norm=spec.norm), "blocks": []}
    for _ in range(spec.n_stages - 1):
        nf_out = min(nf * 2, spec.nf_max)
        p["blocks"].append(_res_block(nf, nf_out, spec.norm, stride=2))
        nf = nf_out
    p["bottleneck"] = _res_block(nf, spec.nf_max, spec.norm)
    if spec.variational:
        for head in ("make_mu", "make_sigma"):
            p[head] = dict(_wn_conv(spec.nf_max, spec.nf_max, 3),
                           gamma=_f(1, 1, 1, spec.nf_max), beta=_f(1, 1, 1, spec.nf_max))
    return {"encoder": p}


def _first_stage(fs):
    z = fs.z_dim
    gate = {"w": _f(z, 2 * z, 3, 3), "b": _f(z)}
    dec = fs.decoder_spec
    ch = dec.dec_channels
    p = {
        "rnn": [{"reset": dict(gate), "update": dict(gate), "out": dict(gate)}
                for _ in range(fs.n_gru_layers)],
        "gen": {
            "in_block": _res_block(z, ch[0], dec.norm),
            "blocks": [_res_block(ch[i], ch[i + 1], "none", upsampling=True)
                       for i in range(dec.n_stages)],
            "spades": [{"conv": {"w": _f(128, 3, 3, 3), "b": _f(128)},
                        "conv_gamma": {"w": _f(nf, 128, 3, 3), "b": _f(nf)},
                        "conv_beta": {"w": _f(nf, 128, 3, 3), "b": _f(nf)}} for nf in ch[1:]],
            "out_conv": _conv_block(ch[-1], dec.out_channels),
        },
    }
    if fs.motion_bias:
        p["motion_bias"] = _f(1, fs.min_spatial_size, fs.min_spatial_size, z)
    return p


def param_shapes(spec):
    """Leaf tree of the second stage's sampling-path params."""
    if spec.augment_channels:
        raise NotImplementedError("augmented flow input is not ported yet (ROADMAP.md queue 1)")
    p = {"flow": flow_shapes(spec.flow), "first_stage": _first_stage(spec.first_stage),
         "poke_embedder": _encoder(spec.poke_embedder)}
    if spec.use_cond:
        p["conditioner"] = _encoder(spec.conditioner)
    s = spec.first_stage.min_spatial_size
    adapters = [("conv_adapt_poke_emb", spec.poke_embedder)]
    if spec.use_cond:
        adapters.append(("conv_adapt_cond", spec.conditioner))
    for name, w in adapters:
        if w.min_spatial_size != s:
            p[name] = _conv_block(w.nf_max, w.nf_max, transposed=w.min_spatial_size < s)["conv"]
    return p


def _fill(tree, gen, device):
    if isinstance(tree, Leaf):
        if tree.kind == "perm":
            return torch.randperm(tree.shape[0], generator=gen, device=device)
        return torch.randn(tree.shape, generator=gen, device=device).mul_(0.05)
    if isinstance(tree, dict):
        return {k: _fill(v, gen, device) for k, v in tree.items()}
    return [_fill(v, gen, device) for v in tree]


def synth_params(spec, seed: int = 0, device=None):
    """Second-stage params filled on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _fill(param_shapes(spec), gen, device)


def set_flow_output_gains(flow_params, gain: float):
    """Set the gains ``g`` of the flow's output convs (MCF ``conv1x1``, NICE
    ``conv3``) to ``gain`` and their biases to zero; other leaves are shared."""
    def walk(node, in_out_conv):
        if isinstance(node, dict):
            if in_out_conv and "g" in node and "b" in node:
                return dict(node, g=torch.full_like(node["g"], gain),
                            b=torch.zeros_like(node["b"]))
            return {k: walk(v, in_out_conv or k in ("conv1x1", "conv3")) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_out_conv) for v in node]
        return node

    return walk(flow_params, False)


def zero_flow_output_convs(flow_params):
    """Zero the gains and biases of the flow's output convs, as a fresh init
    does: a raw synthetic fill there makes the 50-step reverse overflow.
    Every MCF and NICE coupling is then the identity."""
    return set_flow_output_gains(flow_params, 0.0)
