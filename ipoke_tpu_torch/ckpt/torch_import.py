"""Reference-checkpoint ingestion (the port's copy of
``ipoke_tpu/ckpt/torch_import.py``): the reference's Lightning state_dicts
and the metric networks' torch files -> parameter trees in the JAX
package's npz layout, which ``ckpt/io.save`` writes and
``ckpt/jax_bridge.bridge_second_stage`` turns into the port's params.

Layout transforms (torch -> npz layout):
  Conv2d        (O,I,kh,kw)      -> HWIO
  ConvTranspose (I,O,kh,kw)      -> HWIO (I=in, O=out)
  Conv3d        (O,I,D,H,W)      -> DHWIO
  weight_norm   weight_g (O,1,..), weight_v (O,I,..) -> v: HWIO, g: (O,)
  spectral_norm weight_orig + u/v buffers -> w = W/sigma folded, u kept
  ActNorm2dFlow log_scale/bias (C,1,1)   -> (C,)
  Shuffle       forward/backward_shuffle_idx buffers -> fwd_idx/inv_idx (int32)

Per level, the MaCowSteps are stacked on a new leading axis.  Every
converter is numpy, with the JAX package's dtypes at the leaves (float64 ->
float32, int64 -> int32, as ``jnp.asarray`` gives them), so a tree
converted here is bitwise the JAX package's.

The ``export_*`` functions are the inverses: they write a reference-shaped
state_dict from a tree of that layout and document the key schema.  The
attention NICE coupling and the ``cond_conv_block`` of a MaCowUnit convert
as in JAX (NIN projections ``W`` as stored, pos_emb and the LayerNorm's
affine CHW -> HWC).  As in JAX, no converter reads a multistack flow or a
conv-LU 1x1 conv.  The legacy flows convert on their own, as in JAX:
``convert_macow_v1_step`` (a MaCow v1 step, ``flows/macow_v1``) and
``convert_fc_flow`` (the fully connected ConditionalFlow, ``flows/legacy``);
as in JAX, ``convert_flow`` refuses a MaCow v2 flow that holds their keys
(``NotImplementedError`` naming the converter).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage

LEGACY = ("a legacy flow inside a MaCow v2 flow, which the JAX package does not convert "
          "either; convert the legacy flow alone with ckpt/torch_import.{}")


def _arr(x):
    """``x`` as numpy with JAX's default dtypes (``jnp.asarray`` without x64)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


# ---------------------------------------------------------------------------
# primitive converters
# ---------------------------------------------------------------------------

def conv2d_w(t):
    return _arr(np.transpose(np.asarray(t), (2, 3, 1, 0)))


def convT2d_w(t):
    return _arr(np.transpose(np.asarray(t), (2, 3, 0, 1)))


def conv3d_w(t):
    return _arr(np.transpose(np.asarray(t), (2, 3, 4, 1, 0)))


def linear_w(t):
    return _arr(np.transpose(np.asarray(t)))


def wn_conv(sd, prefix):
    """Conv2dWeightNorm / torch weight_norm: keys {prefix}.weight_g/.weight_v/.bias"""
    out = {"v": conv2d_w(sd[f"{prefix}.weight_v"]),
           "g": _arr(np.asarray(sd[f"{prefix}.weight_g"]).reshape(-1))}
    if f"{prefix}.bias" in sd:
        out["b"] = _arr(sd[f"{prefix}.bias"])
    return out


def sn_conv(sd, prefix, keep_u=True, transpose=conv2d_w, dim=0):
    """spectral_norm conv: sigma folded into the weight (inference parity).
    Keys: {prefix}.weight_orig, {prefix}.weight_u, {prefix}.weight_v (opt),
    or a plain {prefix}.weight.

    ``dim`` is the output axis torch reshapes along: 0 for Conv2d, **1 for
    ConvTranspose2d** (torch.nn.utils.spectral_norm's default); 0 for a
    transpose conv computes a wrong sigma."""
    if f"{prefix}.weight_orig" in sd:
        w_t = np.asarray(sd[f"{prefix}.weight_orig"])
        u = np.asarray(sd[f"{prefix}.weight_u"])
        w_mat = np.moveaxis(w_t, dim, 0).reshape(w_t.shape[dim], -1)
        if f"{prefix}.weight_v" in sd:
            v = np.asarray(sd[f"{prefix}.weight_v"])
        else:
            v = w_mat.T @ u
            v = v / (np.linalg.norm(v) + 1e-12)
        sigma = float(u @ (w_mat @ v))
        w = w_t / sigma
    else:
        w = np.asarray(sd[f"{prefix}.weight"])
        u = None
    out = {"w": transpose(w)}
    if f"{prefix}.bias" in sd:
        out["b"] = _arr(sd[f"{prefix}.bias"])
    if keep_u and u is not None:
        out["u"] = _arr(u)
    return out


def plain_conv(sd, prefix, transpose=conv2d_w):
    out = {"w": transpose(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["b"] = _arr(sd[f"{prefix}.bias"])
    return out


def actnorm(sd, prefix):
    return {"log_scale": _arr(np.asarray(sd[f"{prefix}.log_scale"]).reshape(-1)),
            "bias": _arr(np.asarray(sd[f"{prefix}.bias"]).reshape(-1))}


def shuffle(sd, prefix):
    return {"fwd_idx": np.asarray(sd[f"{prefix}.forward_shuffle_idx"], np.int32),
            "inv_idx": np.asarray(sd[f"{prefix}.backward_shuffle_idx"], np.int32)}


def group_norm_p(sd, prefix):
    return {"gamma": _arr(sd[f"{prefix}.weight"]), "beta": _arr(sd[f"{prefix}.bias"])}


# ---------------------------------------------------------------------------
# flow (SupervisedMacowTransformer / MultiScaleInternal under 'flow.flow.')
# ---------------------------------------------------------------------------

def _mcf(sd, prefix):
    if f"{prefix}.net.masked_conv.conv.weight_v" in sd:
        raise NotImplementedError(
            f"{prefix}.net.masked_conv.conv.weight_v: a MaCow v1 MCF, "
            + LEGACY.format("convert_macow_v1_step"))
    return {"net": {"shift_conv": plain_conv(sd, f"{prefix}.net.shift_conv"),
                    "conv1x1": wn_conv(sd, f"{prefix}.net.conv1x1.conv")}}


def _gated_conv(sd, prefix):
    """modules.GatedConv2d: plain weight/bias convs."""
    p = {"conv1": plain_conv(sd, f"{prefix}.conv1"), "conv2": plain_conv(sd, f"{prefix}.conv2")}
    for name in ("conv_sc", "cond_conv"):
        if f"{prefix}.{name}.weight" in sd:
            p[name] = plain_conv(sd, f"{prefix}.{name}")
    return p


def _chw_to_hwc(t):
    return _arr(np.transpose(np.asarray(t), (1, 2, 0)))


def _attn_block(sd, prefix):
    """modules.BasicConvAttnBlock: the gated resnet, the NIN-projection
    attention, LayerNorm((C, H, W))'s affine as (H, W, C)."""
    return {
        "gated": _gated_conv(sd, f"{prefix}.gated_resnet"),
        "attn": {f"proj{i}": {"w": _arr(sd[f"{prefix}.attn.proj_{i}.W"]),
                              "b": _arr(sd[f"{prefix}.attn.proj_{i}.b"])} for i in (1, 2)},
        "ln": {"gamma": _chw_to_hwc(sd[f"{prefix}.norm.weight"]),
               "beta": _chw_to_hwc(sd[f"{prefix}.norm.bias"])},
    }


def _nice(sd, prefix):
    if f"{prefix}.net.pos_emb" in sd:   # the attention NICEConvBlock
        return {"net": {"in_resnet": _gated_conv(sd, f"{prefix}.net.in_resnet"),
                        "pos_emb": _chw_to_hwc(sd[f"{prefix}.net.pos_emb"]),
                        "conv1": _attn_block(sd, f"{prefix}.net.conv1"),
                        "conv2": _attn_block(sd, f"{prefix}.net.conv2"),
                        "conv3": wn_conv(sd, f"{prefix}.net.conv3.conv")}}
    return {"net": {"conv1": plain_conv(sd, f"{prefix}.net.conv1"),
                    "conv2": plain_conv(sd, f"{prefix}.net.conv2"),
                    "conv3": wn_conv(sd, f"{prefix}.net.conv3.conv")}}


def _macow_unit(sd, prefix):
    p = {}
    if f"{prefix}.cond_conv_block.conv1.weight" in sd:   # a conditioned MaCowUnit
        p["cond_conv_block"] = _gated_conv(sd, f"{prefix}.cond_conv_block")
    p.update({
        "conv1": _mcf(sd, f"{prefix}.conv1"),
        "conv2": _mcf(sd, f"{prefix}.conv2"),
        "actnorm1": actnorm(sd, f"{prefix}.actnorm1"),
        "conv3": _mcf(sd, f"{prefix}.conv3"),
        "conv4": _mcf(sd, f"{prefix}.conv4"),
        "actnorm2": actnorm(sd, f"{prefix}.actnorm2"),
    })
    return p


def _macow_step(sd, prefix):
    return {
        "actnorm1": actnorm(sd, f"{prefix}.actnorm1"),
        "conv1x1": shuffle(sd, f"{prefix}.conv1x1"),
        "units1": [_macow_unit(sd, f"{prefix}.units1.{i}") for i in range(2)],
        "coupling1_up": _nice(sd, f"{prefix}.coupling1_up"),
        "coupling1_dn": _nice(sd, f"{prefix}.coupling1_dn"),
        "actnorm2": actnorm(sd, f"{prefix}.actnorm2"),
        "units2": [_macow_unit(sd, f"{prefix}.units2.{i}") for i in range(2)],
        "coupling2_up": _nice(sd, f"{prefix}.coupling2_up"),
        "coupling2_dn": _nice(sd, f"{prefix}.coupling2_dn"),
    }


def _prior(sd, prefix):
    return {"conv1x1": shuffle(sd, f"{prefix}.conv1x1"),
            "coupling": _nice(sd, f"{prefix}.coupling"),
            "actnorm": actnorm(sd, f"{prefix}.actnorm")}


def stack_step_params(steps):
    """Per-step MaCowStep trees -> one tree, each leaf stacked on a new
    leading axis (the scanned layout of the JAX package)."""
    head = steps[0]
    if isinstance(head, dict):
        return {k: stack_step_params([s[k] for s in steps]) for k in head}
    if isinstance(head, list):
        return [stack_step_params([s[i] for s in steps]) for i in range(len(head))]
    return np.stack(steps)


def convert_flow(sd: Dict[str, np.ndarray], spec, prefix="flow.flow"):
    """MultiScaleInternal state_dict -> the stacked-level flow tree;
    ``spec``: a FlowSpec (its ``num_steps``)."""
    if any(k.startswith(f"{prefix}.sub_layers.") for k in sd):
        raise NotImplementedError(f"{prefix}.sub_layers.*: a fully connected flow, "
                                  + LEGACY.format("convert_fc_flow"))
    levels = []
    for li, n_steps in enumerate(spec.num_steps):
        steps = [_macow_step(sd, f"{prefix}.layers.{li}.{si}") for si in range(n_steps)]
        levels.append({"steps": stack_step_params(steps),
                       "prior": _prior(sd, f"{prefix}.priors.{li}"),
                       "shuffle": shuffle(sd, f"{prefix}.shuffle_layers.{li}")})
    return {"levels": levels}


# ---------------------------------------------------------------------------
# the legacy flows: a MaCow v1 step, the fully connected ConditionalFlow
# ---------------------------------------------------------------------------

def _mcf_v1(sd, prefix):
    p = {"shift_conv": wn_conv(sd, f"{prefix}.net.masked_conv.conv"),
         "conv1x1": wn_conv(sd, f"{prefix}.net.conv1x1.conv")}
    if f"{prefix}.s_conv.conv.weight_v" in sd:
        p["s_conv"] = wn_conv(sd, f"{prefix}.s_conv.conv")
    return p


def convert_macow_v1_step(sd, spec, prefix=""):
    """A MaCow v1 unconditional step -> the ``flows/macow_v1`` tree;
    ``spec``: a MaCowV1Spec.  The NICE's conv3 (the reference's zero-init
    conv) is a plain conv."""
    pre = f"{prefix}." if prefix else ""
    units = []
    for i in range(spec.num_units):
        up = f"{pre}units.{i}"
        units.append({"actnorm1": actnorm(sd, f"{up}.actnorm1"), "conv1": _mcf_v1(sd, f"{up}.conv1"),
                      "conv2": _mcf_v1(sd, f"{up}.conv2"), "actnorm2": actnorm(sd, f"{up}.actnorm2"),
                      "conv3": _mcf_v1(sd, f"{up}.conv3"), "conv4": _mcf_v1(sd, f"{up}.conv4")})
    gp = f"{pre}glow_step"
    return {"units": units,
            "glow": {"actnorm": actnorm(sd, f"{gp}.actnorm"),
                     "shuffle": shuffle(sd, f"{gp}.conv1x1"),
                     "nice": {"conv1": wn_conv(sd, f"{gp}.coupling.net.conv1.conv"),
                              "conv2": wn_conv(sd, f"{gp}.coupling.net.conv2.conv"),
                              "conv3": plain_conv(sd, f"{gp}.coupling.net.conv3.conv")}}}


def _fc_net(sd, prefix, depth, use_tanh):
    """BasicFullyConnectedNet: its Linear layers at the even Sequential
    indices 0, 2, ..., 2 (depth + 1), LeakyReLUs between."""
    return {"layers": [{"w": linear_w(sd[f"{prefix}.main.{2 * j}.weight"]),
                        "b": _arr(sd[f"{prefix}.main.{2 * j}.bias"])} for j in range(depth + 2)],
            "use_tanh": use_tanh}


def convert_fc_flow(sd, spec, prefix=""):
    """The fully connected ConditionalFlow -> the ``flows/legacy`` tree;
    ``spec``: an FCFlowSpec."""
    pre = f"{prefix}." if prefix else ""
    blocks = []
    for i in range(spec.n_flows):
        bp = f"{pre}sub_layers.{i}"
        net = lambda kind, j, tanh: _fc_net(sd, f"{bp}.coupling.{kind}.{j}",  # noqa: E731
                                            spec.hidden_depth, tanh)
        blocks.append({
            "actnorm": {"loc": _arr(np.asarray(sd[f"{bp}.norm_layer.loc"]).reshape(-1)),
                        "scale": _arr(np.asarray(sd[f"{bp}.norm_layer.scale"]).reshape(-1))},
            "coupling": {"s": [net("s", j, True) for j in range(2)],
                         "t": [net("t", j, False) for j in range(2)]},
            "shuffle": shuffle(sd, f"{bp}.shuffle")})
    p = {"blocks": blocks}
    if spec.conditioning_option != "none":
        p["cond_layers"] = [{"w": conv2d_w(sd[f"{pre}conditioning_layers.{i}.weight"]),
                             "b": _arr(sd[f"{pre}conditioning_layers.{i}.bias"])}
                            for i in range(spec.n_flows)]
    return p


# ---------------------------------------------------------------------------
# conditioning towers (FirstStageWrapper: encoder/decoder)
# ---------------------------------------------------------------------------

def _conv2d_block(sd, prefix, norm="group"):
    p = {"conv": sn_conv(sd, f"{prefix}.conv")}
    if norm == "group" and f"{prefix}.norm.weight" in sd:
        p["norm"] = group_norm_p(sd, f"{prefix}.norm")
    return p


def _has_res_conv(sd, prefix):
    return f"{prefix}.res_conv.conv.weight" in sd or f"{prefix}.res_conv.conv.weight_orig" in sd


def _res_block(sd, prefix, norm="group"):
    p = {"conv1": _conv2d_block(sd, f"{prefix}.conv1", norm),
         "conv2": _conv2d_block(sd, f"{prefix}.conv2", norm)}
    if _has_res_conv(sd, prefix):
        p["res_conv"] = _conv2d_block(sd, f"{prefix}.res_conv", norm="none")
    return p


def _res_block_T(sd, prefix, norm="group"):
    """Upsampling ResBlock: conv1 and res_conv are ConvTranspose (sn dim=1)."""
    p = {"conv1": {"conv": sn_conv(sd, f"{prefix}.conv1.conv", transpose=convT2d_w, dim=1)},
         "conv2": _conv2d_block(sd, f"{prefix}.conv2", norm)}
    if f"{prefix}.conv1.norm.weight" in sd:
        p["conv1"]["norm"] = group_norm_p(sd, f"{prefix}.conv1.norm")
    if _has_res_conv(sd, prefix):
        p["res_conv"] = {"conv": sn_conv(sd, f"{prefix}.res_conv.conv", transpose=convT2d_w, dim=1)}
    return p


def _norm_conv2d(sd, prefix):
    return {
        "v": conv2d_w(sd[f"{prefix}.conv.weight_v"]),
        "g": _arr(np.asarray(sd[f"{prefix}.conv.weight_g"]).reshape(-1)),
        "b": _arr(sd[f"{prefix}.conv.bias"]),
        "gamma": _arr(np.asarray(sd[f"{prefix}.gamma"]).reshape(1, 1, 1, -1)),
        "beta": _arr(np.asarray(sd[f"{prefix}.beta"]).reshape(1, 1, 1, -1)),
    }


def convert_conv_encoder(sd, n_stages, variational, prefix="encoder", norm="group"):
    """ConvEncoder state_dict (model.{i} sequential + bottleneck.0 + heads)."""
    p = {"stem": _conv2d_block(sd, f"{prefix}.model.0", norm),
         "blocks": [_res_block(sd, f"{prefix}.model.{i}", norm) for i in range(1, n_stages)],
         "bottleneck": _res_block(sd, f"{prefix}.bottleneck.0", norm)}
    if variational:
        p["make_mu"] = _norm_conv2d(sd, f"{prefix}.make_mu")
        p["make_sigma"] = _norm_conv2d(sd, f"{prefix}.make_sigma")
    return p


def convert_conv_decoder(sd, n_stages, prefix="decoder", norm="group"):
    return {"in_block": _res_block(sd, f"{prefix}.in_block", norm),
            "blocks": [_res_block_T(sd, f"{prefix}.blocks.{i}", norm) for i in range(n_stages)],
            "out_conv": _conv2d_block(sd, f"{prefix}.out_conv", norm="none")}


def convert_wrapper(sd, spec, prefix=""):
    """FirstStageWrapper (poke embedder / conditioner), both halves."""
    pre = f"{prefix}." if prefix else ""
    enc_spec = spec.encoder_spec
    return {
        "encoder": convert_conv_encoder(sd, enc_spec.n_stages, enc_spec.variational,
                                        prefix=f"{pre}encoder"),
        "decoder": convert_conv_decoder(sd, len(spec.decoder_spec.in_channels) - 1,
                                        prefix=f"{pre}decoder"),
    }


# ---------------------------------------------------------------------------
# first stage (SpadeCondMotionModel)
# ---------------------------------------------------------------------------

def _basic_block3d(sd, prefix):
    p = {"conv1": {"w": conv3d_w(sd[f"{prefix}.conv1.weight"])},
         "gn1": group_norm_p(sd, f"{prefix}.bn1"),
         "conv2": {"w": conv3d_w(sd[f"{prefix}.conv2.weight"])},
         "gn2": group_norm_p(sd, f"{prefix}.bn2")}
    if f"{prefix}.downsample.0.weight" in sd:
        p["down"] = {"w": conv3d_w(sd[f"{prefix}.downsample.0.weight"]),
                     "gn": group_norm_p(sd, f"{prefix}.downsample.1")}
    return p


def convert_motion_encoder(sd, spec, prefix="enc_motion"):
    _, _, _, has_l4, has_l5, _ = spec.derived()
    p = {"conv1": {"w": conv3d_w(sd[f"{prefix}.conv1.weight"])},
         "gn1": group_norm_p(sd, f"{prefix}.bn1"),
         "conv_mu": plain_conv(sd, f"{prefix}.conv_mu"),
         "conv_var": plain_conv(sd, f"{prefix}.conv_var")}
    n_layers = 5 if has_l5 else (4 if has_l4 else 3)
    for li in range(1, n_layers + 1):
        blocks, bi = [], 0
        while f"{prefix}.layer{li}.{bi}.conv1.weight" in sd:
            blocks.append(_basic_block3d(sd, f"{prefix}.layer{li}.{bi}"))
            bi += 1
        p[f"layer{li}"] = blocks
    return p


def _gru_cell(sd, prefix):
    return {"reset": plain_conv(sd, f"{prefix}.reset_gate"),
            "update": plain_conv(sd, f"{prefix}.update_gate"),
            "out": plain_conv(sd, f"{prefix}.out_gate")}


def _spade(sd, prefix):
    return {"conv": plain_conv(sd, f"{prefix}.conv"),
            "conv_gamma": plain_conv(sd, f"{prefix}.conv_gamma"),
            "conv_beta": plain_conv(sd, f"{prefix}.conv_beta")}


def convert_first_stage(sd, spec, prefix=""):
    """SpadeCondMotionModel (enc_motion + rnn + gen + motion_bias).  The
    discriminators' keys (disc_s/disc_t) and the metrics' are ignored, as the
    reference loads these checkpoints with strict=False."""
    pre = f"{prefix}." if prefix else ""
    p = {
        "enc_motion": convert_motion_encoder(sd, spec.encoder_spec, prefix=f"{pre}enc_motion"),
        "rnn": [_gru_cell(sd, f"{pre}rnn.cells.{i}") for i in range(spec.n_gru_layers)],
        "gen": {
            "in_block": _res_block(sd, f"{pre}gen.in_block", spec.norm),
            "blocks": [_res_block_T(sd, f"{pre}gen.blocks.{i}", "none")
                       for i in range(spec.decoder_spec.n_stages)],
            "spades": [_spade(sd, f"{pre}gen.spade_blocks.{i}")
                       for i in range(spec.decoder_spec.n_stages)],
            "out_conv": _conv2d_block(sd, f"{pre}gen.out_conv", norm="none"),
        },
    }
    if spec.motion_bias:
        p["motion_bias"] = _arr(np.transpose(np.asarray(sd[f"{pre}motion_bias"]), (0, 2, 3, 1)))
    return p


# ---------------------------------------------------------------------------
# second stage assembly
# ---------------------------------------------------------------------------

def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_second_stage(sd, spec, first_stage_sd=None, cond_sd=None, poke_sd=None):
    """PokeMotionModel checkpoint.  The Lightning checkpoint embeds the
    frozen submodels under the prefixes first_stage_model., poke_embedder.
    and conditioner.; those win, and separately passed sub-state_dicts fill
    the gaps.  ``spec``: the port's SecondStageSpec."""
    params = {"flow": convert_flow(sd, spec.flow, prefix="flow.flow")}
    fs_sd = _sub(sd, "first_stage_model.") or first_stage_sd or {}
    params["first_stage"] = convert_first_stage(fs_sd, spec.first_stage)
    pe_sd = _sub(sd, "poke_embedder.") or poke_sd or {}
    params["poke_embedder"] = convert_wrapper(pe_sd, spec.poke_embedder)
    if spec.use_cond:
        c_sd = _sub(sd, "conditioner.") or cond_sd or {}
        params["conditioner"] = convert_wrapper(c_sd, spec.conditioner)
    if "scale_augment" in sd:
        params["scale_augment"] = _arr(sd["scale_augment"])
        params["shift_augment"] = _arr(sd["shift_augment"])
    for name in ("conv_adapt_poke_emb", "conv_adapt_cond"):
        if f"{name}.weight" in sd:
            params[name] = plain_conv(sd, name)
    return params


def to_port(sd, spec, device=None, **sub_sds):
    """A reference state_dict -> the port's params on ``device``:
    ``convert_second_stage`` (``sub_sds``: its first_stage_sd, cond_sd,
    poke_sd), then ``jax_bridge.bridge_second_stage``."""
    return bridge_second_stage(convert_second_stage(sd, spec, **sub_sds), spec, device)


def load_lightning_ckpt(path):
    """Read a Lightning .ckpt with torch on the CPU; {key: np.ndarray} of its
    state_dict.  ``weights_only=False``: a Lightning file pickles its
    hyper-parameters, which torch >= 2.6 refuses by default."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# exporters: npz layout -> reference-shaped state_dict (numpy)
# ---------------------------------------------------------------------------

def _torch_layout(w, transposed=False):
    """The inverse of conv2d_w / convT2d_w / conv3d_w."""
    w = np.asarray(w)
    if w.ndim == 5:
        return np.transpose(w, (4, 3, 0, 1, 2))
    return np.transpose(w, (2, 3, 0, 1) if transposed else (3, 2, 0, 1))


def _export_wn(p, prefix, sd):
    o = p["v"].shape[-1]
    sd[f"{prefix}.weight_v"] = np.transpose(np.asarray(p["v"]), (3, 2, 0, 1))
    sd[f"{prefix}.weight_g"] = np.asarray(p["g"]).reshape(o, 1, 1, 1)
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _export_conv(p, prefix, sd, transposed=False):
    sd[f"{prefix}.weight"] = _torch_layout(p["w"], transposed)
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _export_actnorm(p, prefix, sd):
    c = p["log_scale"].shape[0]
    sd[f"{prefix}.log_scale"] = np.asarray(p["log_scale"]).reshape(c, 1, 1)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"]).reshape(c, 1, 1)


def _export_shuffle(p, prefix, sd):
    sd[f"{prefix}.forward_shuffle_idx"] = np.asarray(p["fwd_idx"])
    sd[f"{prefix}.backward_shuffle_idx"] = np.asarray(p["inv_idx"])


def _export_mcf(p, prefix, sd):
    _export_conv(p["net"]["shift_conv"], f"{prefix}.net.shift_conv", sd)
    _export_wn(p["net"]["conv1x1"], f"{prefix}.net.conv1x1.conv", sd)


def _export_gated(p, prefix, sd):
    for name in ("conv1", "conv2", "conv_sc", "cond_conv"):
        if name in p:
            _export_conv(p[name], f"{prefix}.{name}", sd)


def _hwc_to_chw(t):
    return np.transpose(np.asarray(t), (2, 0, 1))


def _export_attn_block(p, prefix, sd):
    _export_gated(p["gated"], f"{prefix}.gated_resnet", sd)
    for i in (1, 2):
        sd[f"{prefix}.attn.proj_{i}.W"] = np.asarray(p["attn"][f"proj{i}"]["w"])
        sd[f"{prefix}.attn.proj_{i}.b"] = np.asarray(p["attn"][f"proj{i}"]["b"])
    sd[f"{prefix}.norm.weight"] = _hwc_to_chw(p["ln"]["gamma"])
    sd[f"{prefix}.norm.bias"] = _hwc_to_chw(p["ln"]["beta"])


def _export_nice(p, prefix, sd):
    net = p["net"]
    if "in_resnet" in net:
        _export_gated(net["in_resnet"], f"{prefix}.net.in_resnet", sd)
        sd[f"{prefix}.net.pos_emb"] = _hwc_to_chw(net["pos_emb"])
        _export_attn_block(net["conv1"], f"{prefix}.net.conv1", sd)
        _export_attn_block(net["conv2"], f"{prefix}.net.conv2", sd)
    else:
        _export_conv(net["conv1"], f"{prefix}.net.conv1", sd)
        _export_conv(net["conv2"], f"{prefix}.net.conv2", sd)
    _export_wn(net["conv3"], f"{prefix}.net.conv3.conv", sd)


def _export_unit(p, prefix, sd):
    if "cond_conv_block" in p:
        _export_gated(p["cond_conv_block"], f"{prefix}.cond_conv_block", sd)
    for name in ("conv1", "conv2", "conv3", "conv4"):
        _export_mcf(p[name], f"{prefix}.{name}", sd)
    _export_actnorm(p["actnorm1"], f"{prefix}.actnorm1", sd)
    _export_actnorm(p["actnorm2"], f"{prefix}.actnorm2", sd)


def _step(tree, si):
    if isinstance(tree, dict):
        return {k: _step(v, si) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_step(v, si) for v in tree]
    return np.asarray(tree)[si]


def export_flow(params, spec, prefix="flow.flow"):
    """The (stacked) flow tree -> a reference-shaped state_dict (numpy)."""
    sd = {}
    for li, level in enumerate(params["levels"]):
        for si in range(spec.num_steps[li]):
            step = _step(level["steps"], si)
            pre = f"{prefix}.layers.{li}.{si}"
            _export_actnorm(step["actnorm1"], f"{pre}.actnorm1", sd)
            _export_shuffle(step["conv1x1"], f"{pre}.conv1x1", sd)
            for ui, unit in enumerate(step["units1"]):
                _export_unit(unit, f"{pre}.units1.{ui}", sd)
            _export_nice(step["coupling1_up"], f"{pre}.coupling1_up", sd)
            _export_nice(step["coupling1_dn"], f"{pre}.coupling1_dn", sd)
            _export_actnorm(step["actnorm2"], f"{pre}.actnorm2", sd)
            for ui, unit in enumerate(step["units2"]):
                _export_unit(unit, f"{pre}.units2.{ui}", sd)
            _export_nice(step["coupling2_up"], f"{pre}.coupling2_up", sd)
            _export_nice(step["coupling2_dn"], f"{pre}.coupling2_dn", sd)
        _export_shuffle(level["prior"]["conv1x1"], f"{prefix}.priors.{li}.conv1x1", sd)
        _export_nice(level["prior"]["coupling"], f"{prefix}.priors.{li}.coupling", sd)
        _export_actnorm(level["prior"]["actnorm"], f"{prefix}.priors.{li}.actnorm", sd)
        _export_shuffle(level["shuffle"], f"{prefix}.shuffle_layers.{li}", sd)
    return sd


def export_macow_v1_step(params, spec, prefix=""):
    """A ``flows/macow_v1`` step tree (JAX's layout) -> the reference-shaped
    state_dict ``convert_macow_v1_step`` reads."""
    pre = f"{prefix}." if prefix else ""
    sd = {}
    for i, unit in enumerate(params["units"]):
        up = f"{pre}units.{i}"
        for name in ("actnorm1", "actnorm2"):
            _export_actnorm(unit[name], f"{up}.{name}", sd)
        for name in ("conv1", "conv2", "conv3", "conv4"):
            _export_wn(unit[name]["shift_conv"], f"{up}.{name}.net.masked_conv.conv", sd)
            _export_wn(unit[name]["conv1x1"], f"{up}.{name}.net.conv1x1.conv", sd)
            if "s_conv" in unit[name]:
                _export_wn(unit[name]["s_conv"], f"{up}.{name}.s_conv.conv", sd)
    gp, glow = f"{pre}glow_step", params["glow"]
    _export_actnorm(glow["actnorm"], f"{gp}.actnorm", sd)
    _export_shuffle(glow["shuffle"], f"{gp}.conv1x1", sd)
    _export_wn(glow["nice"]["conv1"], f"{gp}.coupling.net.conv1.conv", sd)
    _export_wn(glow["nice"]["conv2"], f"{gp}.coupling.net.conv2.conv", sd)
    _export_conv(glow["nice"]["conv3"], f"{gp}.coupling.net.conv3.conv", sd)
    return sd


def export_fc_flow(params, spec, prefix=""):
    """A ``flows/legacy`` FC flow tree (JAX's layout) -> the reference-shaped
    state_dict ``convert_fc_flow`` reads (the actnorm as (1, C, 1, 1))."""
    pre = f"{prefix}." if prefix else ""
    sd = {}
    for i, blk in enumerate(params["blocks"]):
        bp = f"{pre}sub_layers.{i}"
        for name in ("loc", "scale"):
            sd[f"{bp}.norm_layer.{name}"] = np.asarray(blk["actnorm"][name]).reshape(1, -1, 1, 1)
        for kind in ("s", "t"):
            for j, net in enumerate(blk["coupling"][kind]):
                for k, layer in enumerate(net["layers"]):
                    sd[f"{bp}.coupling.{kind}.{j}.main.{2 * k}.weight"] = np.asarray(layer["w"]).T
                    sd[f"{bp}.coupling.{kind}.{j}.main.{2 * k}.bias"] = np.asarray(layer["b"])
        _export_shuffle(blk["shuffle"], f"{bp}.shuffle", sd)
    for i, cl in enumerate(params.get("cond_layers", [])):
        _export_conv(cl, f"{pre}conditioning_layers.{i}", sd)
    return sd


def _unit_vector(x):
    return x / max(float(np.linalg.norm(x)), 1e-12)


def _export_sn(p, prefix, sd, transposed, spectral):
    """A conv that the reference may spectral-norm.  With ``spectral`` "orig"
    and a ``u`` in ``p``, torch's stored form: ``weight_orig`` (= ``w``),
    ``weight_u``, ``weight_v`` after one power iteration from ``u`` (so
    ``u`` is parallel to W v, as torch leaves them), no ``weight``;
    otherwise a plain ``weight``."""
    w_t = _torch_layout(p["w"], transposed)
    if spectral == "orig" and "u" in p:
        dim = 1 if transposed else 0
        w_mat = np.moveaxis(w_t, dim, 0).reshape(w_t.shape[dim], -1)
        v = _unit_vector(w_mat.T @ np.asarray(p["u"]))
        u = _unit_vector(w_mat @ v)
        sd[f"{prefix}.weight_orig"] = w_t
        sd[f"{prefix}.weight_u"] = u.astype(w_t.dtype)
        sd[f"{prefix}.weight_v"] = v.astype(w_t.dtype)
    else:
        sd[f"{prefix}.weight"] = w_t
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _export_gn(p, prefix, sd):
    sd[f"{prefix}.weight"] = np.asarray(p["gamma"])
    sd[f"{prefix}.bias"] = np.asarray(p["beta"])


def _export_conv2d_block(p, prefix, sd, spectral, transposed=False):
    _export_sn(p["conv"], f"{prefix}.conv", sd, transposed, spectral)
    if "norm" in p:
        _export_gn(p["norm"], f"{prefix}.norm", sd)


def _export_res_block(p, prefix, sd, spectral, upsampling=False):
    """A ResBlock; ``upsampling``: conv1 and res_conv are transpose convs."""
    _export_conv2d_block(p["conv1"], f"{prefix}.conv1", sd, spectral, upsampling)
    _export_conv2d_block(p["conv2"], f"{prefix}.conv2", sd, spectral)
    if "res_conv" in p:
        _export_conv2d_block(p["res_conv"], f"{prefix}.res_conv", sd, spectral, upsampling)


def _export_norm_conv2d(p, prefix, sd):
    o = p["v"].shape[-1]
    sd[f"{prefix}.conv.weight_v"] = _torch_layout(p["v"])
    sd[f"{prefix}.conv.weight_g"] = np.asarray(p["g"]).reshape(o, 1, 1, 1)
    sd[f"{prefix}.conv.bias"] = np.asarray(p["b"])
    sd[f"{prefix}.gamma"] = np.asarray(p["gamma"]).reshape(1, o, 1, 1)
    sd[f"{prefix}.beta"] = np.asarray(p["beta"]).reshape(1, o, 1, 1)


def export_wrapper(tree, prefix="", spectral="orig"):
    """A tower wrapper tree ({'encoder', 'decoder'}) -> FirstStageWrapper keys."""
    pre, sd = f"{prefix}." if prefix else "", {}
    enc = tree["encoder"]
    _export_conv2d_block(enc["stem"], f"{pre}encoder.model.0", sd, spectral)
    for i, b in enumerate(enc["blocks"]):
        _export_res_block(b, f"{pre}encoder.model.{i + 1}", sd, spectral)
    _export_res_block(enc["bottleneck"], f"{pre}encoder.bottleneck.0", sd, spectral)
    for head in ("make_mu", "make_sigma"):
        if head in enc:
            _export_norm_conv2d(enc[head], f"{pre}encoder.{head}", sd)
    if "decoder" in tree:
        dec = tree["decoder"]
        _export_res_block(dec["in_block"], f"{pre}decoder.in_block", sd, spectral)
        for i, b in enumerate(dec["blocks"]):
            _export_res_block(b, f"{pre}decoder.blocks.{i}", sd, spectral, upsampling=True)
        _export_conv2d_block(dec["out_conv"], f"{pre}decoder.out_conv", sd, spectral)
    return sd


def export_first_stage(tree, prefix="", spectral="orig"):
    """A first-stage tree -> SpadeCondMotionModel keys."""
    pre, sd = f"{prefix}." if prefix else "", {}
    enc = tree["enc_motion"]
    sd[f"{pre}enc_motion.conv1.weight"] = _torch_layout(enc["conv1"]["w"])
    _export_gn(enc["gn1"], f"{pre}enc_motion.bn1", sd)
    _export_conv(enc["conv_mu"], f"{pre}enc_motion.conv_mu", sd)
    _export_conv(enc["conv_var"], f"{pre}enc_motion.conv_var", sd)
    li = 1
    while f"layer{li}" in enc:
        for bi, b in enumerate(enc[f"layer{li}"]):
            bp = f"{pre}enc_motion.layer{li}.{bi}"
            for ci in (1, 2):
                sd[f"{bp}.conv{ci}.weight"] = _torch_layout(b[f"conv{ci}"]["w"])
                _export_gn(b[f"gn{ci}"], f"{bp}.bn{ci}", sd)
            if "down" in b:
                sd[f"{bp}.downsample.0.weight"] = _torch_layout(b["down"]["w"])
                _export_gn(b["down"]["gn"], f"{bp}.downsample.1", sd)
        li += 1
    for i, cell in enumerate(tree["rnn"]):
        for mine, theirs in (("reset", "reset_gate"), ("update", "update_gate"), ("out", "out_gate")):
            _export_conv(cell[mine], f"{pre}rnn.cells.{i}.{theirs}", sd)
    gen = tree["gen"]
    _export_res_block(gen["in_block"], f"{pre}gen.in_block", sd, spectral)
    for i, b in enumerate(gen["blocks"]):
        _export_res_block(b, f"{pre}gen.blocks.{i}", sd, spectral, upsampling=True)
    for i, s in enumerate(gen["spades"]):
        for name in ("conv", "conv_gamma", "conv_beta"):
            _export_conv(s[name], f"{pre}gen.spade_blocks.{i}.{name}", sd)
    _export_conv2d_block(gen["out_conv"], f"{pre}gen.out_conv", sd, spectral)
    if "motion_bias" in tree:
        sd[f"{pre}motion_bias"] = np.transpose(np.asarray(tree["motion_bias"]), (0, 3, 1, 2))
    return sd


def export_second_stage(tree, spec, spectral="orig"):
    """A second-stage tree in the npz layout (towers with both halves, ``u``
    beside each spectral-normed kernel) -> the reference's PokeMotionModel
    state_dict: the flow under ``flow.flow.`` by ``export_flow``, the
    first stage under ``first_stage_model.``, the towers under
    ``poke_embedder.`` / ``conditioner.``, the size adapters and the
    augmentation gains at the top.

    ``spectral``: "orig" writes each conv that carries ``u`` as
    torch.nn.utils.spectral_norm stores it (``weight_orig``, ``weight_u``,
    ``weight_v``); "weight" writes every conv as a plain ``weight``, which
    the converters read back unchanged."""
    if spectral not in ("orig", "weight"):
        raise ValueError(f"spectral {spectral!r} not in ('orig', 'weight')")
    sd = export_flow(tree["flow"], spec.flow) if "flow" in tree else {}
    if "first_stage" in tree:
        sd.update(export_first_stage(tree["first_stage"], "first_stage_model", spectral))
    for name in ("poke_embedder", "conditioner"):
        if name in tree:
            sd.update(export_wrapper(tree[name], name, spectral))
    for name in ("conv_adapt_poke_emb", "conv_adapt_cond"):
        if name in tree:
            _export_conv(tree[name], name, sd)
    for name in ("scale_augment", "shift_augment"):
        if name in tree:
            sd[name] = np.asarray(tree[name])
    return sd


# ---------------------------------------------------------------------------
# metric backbones (perceptual / FVD / FID / pose nets) -> the npz files
# that the port's metrics/* read
# ---------------------------------------------------------------------------

def _savez(out_path, out):
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    return out_path


def _fold_bn(w, gamma, beta, mean, var, eps=1e-3):
    """Fold BatchNorm into conv weight/bias (inference-only nets)."""
    scale = gamma / np.sqrt(var + eps)
    return w * scale.reshape((1,) * (w.ndim - 1) + (-1,)), beta - mean * scale


def _bn(sd, key):
    return (np.asarray(sd[f"{key}.weight"]), np.asarray(sd[f"{key}.bias"]),
            np.asarray(sd[f"{key}.running_mean"]), np.asarray(sd[f"{key}.running_var"]))


def convert_torchvision_vgg(sd, out_path, layout=None):
    """torchvision vgg16/vgg19 state_dict -> vggNN_features.npz
    ({conv{idx}/w OIHW, conv{idx}/b}), read by metrics/vgg.py."""
    out = {}
    for key, val in sd.items():
        if key.startswith("features.") and key.endswith((".weight", ".bias")):
            idx = key.split(".")[1]
            out[f"conv{idx}/{'w' if key.endswith('weight') else 'b'}"] = np.asarray(val)
    return _savez(out_path, out)


_I3D_STEM_UNITS = {
    "conv3d_1a_7x7": "Conv3d_1a_7x7",
    "conv3d_2b_1x1": "Conv3d_2b_1x1",
    "conv3d_2c_3x3": "Conv3d_2c_3x3",
    "conv3d_0c_1x1": "logits",
}


def _i3d_unit_name(torch_name):
    """torch module path -> metrics/i3d.py unit key:
    mixed_3b.branch_1.0 -> Mixed_3b.b1a ; mixed_3b.branch_0 -> Mixed_3b.b0"""
    if torch_name in _I3D_STEM_UNITS:
        return _I3D_STEM_UNITS[torch_name]
    parts = torch_name.split(".")
    blk = "Mixed_" + parts[0].split("_", 1)[1]
    branch = parts[1]  # branch_{0..3}
    if branch == "branch_0":
        return f"{blk}.b0"
    if branch == "branch_3":
        return f"{blk}.b3"  # branch_3.0 is the pool; .1 is the conv
    return f"{blk}.b{branch[-1]}{'a' if parts[2] == '0' else 'b'}"


def convert_i3d(sd, out_path):
    """The reference's i3d_kinetics_rgb.pth (PyTorch I3D of Unit3Dpy modules:
    {name}.conv3d.weight (O,I,D,H,W), {name}.batch3d.{weight,bias,
    running_mean,running_var}) -> i3d_kinetics_rgb.npz: DHWIO kernels, the
    batch norm folded (TF's eps 1e-3), keyed by metrics/i3d.py's units."""
    out = {}
    for name in {k.rsplit(".", 2)[0] for k in sd if k.endswith("conv3d.weight")}:
        w = np.transpose(np.asarray(sd[f"{name}.conv3d.weight"]), (2, 3, 4, 1, 0))
        if f"{name}.batch3d.weight" in sd:
            w, b = _fold_bn(w, *_bn(sd, f"{name}.batch3d"))
        else:
            b = np.asarray(sd.get(f"{name}.conv3d.bias", np.zeros(w.shape[-1], np.float32)))
        unit = _i3d_unit_name(name)
        out[f"{unit}.w"] = w
        out[f"{unit}.b"] = b
    return _savez(out_path, out)


# torchvision InceptionV3 branch-module names -> metrics/fid.py unit names
_INCEPTION_BRANCH_MAP = {
    "A": {"branch1x1": "b1x1.0", "branch5x5_1": "b5x5.0", "branch5x5_2": "b5x5.1",
          "branch3x3dbl_1": "b3x3dbl.0", "branch3x3dbl_2": "b3x3dbl.1",
          "branch3x3dbl_3": "b3x3dbl.2", "branch_pool": "bpool.0"},
    "B": {"branch3x3": "b3x3.0", "branch3x3dbl_1": "b3x3dbl.0",
          "branch3x3dbl_2": "b3x3dbl.1", "branch3x3dbl_3": "b3x3dbl.2"},
    "C": {"branch1x1": "b1x1.0", "branch7x7_1": "b7x7.0", "branch7x7_2": "b7x7.1",
          "branch7x7_3": "b7x7.2", "branch7x7dbl_1": "b7x7dbl.0",
          "branch7x7dbl_2": "b7x7dbl.1", "branch7x7dbl_3": "b7x7dbl.2",
          "branch7x7dbl_4": "b7x7dbl.3", "branch7x7dbl_5": "b7x7dbl.4",
          "branch_pool": "bpool.0"},
    "D": {"branch3x3_1": "b3x3.0", "branch3x3_2": "b3x3.1",
          "branch7x7x3_1": "b7x7x3.0", "branch7x7x3_2": "b7x7x3.1",
          "branch7x7x3_3": "b7x7x3.2", "branch7x7x3_4": "b7x7x3.3"},
    "E": {"branch1x1": "b1x1.0", "branch3x3_1": "b3x3_1.0",
          "branch3x3_2a": "b3x3_2a.0", "branch3x3_2b": "b3x3_2b.0",
          "branch3x3dbl_1": "b3x3dbl_1.0", "branch3x3dbl_2": "b3x3dbl_1.1",
          "branch3x3dbl_3a": "b3x3dbl_2a.0", "branch3x3dbl_3b": "b3x3dbl_2b.0",
          "branch_pool": "bpool.0"},
}

INCEPTION_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                  "Conv2d_4a_3x3")


def convert_inception_v3(sd, out_path):
    """torchvision inception_v3 state_dict -> inception_v3_fid.npz keyed for
    metrics/fid.py (HWIO, BN eps=1e-3 folded).  BasicConv2d units are
    {name}.conv.weight + {name}.bn.{weight,bias,running_mean,running_var}."""
    from ipoke_tpu_torch.metrics.fid import BLOCKS

    out = {}

    def unit(torch_name, out_name):
        w, b = _fold_bn(conv2d_w(sd[f"{torch_name}.conv.weight"]), *_bn(sd, f"{torch_name}.bn"))
        out[f"{out_name}.w"] = w
        out[f"{out_name}.b"] = b

    for stem in INCEPTION_STEM:
        unit(stem, stem)
    for bname, kind, _cin, _extra in BLOCKS:
        for torch_branch, mine in _INCEPTION_BRANCH_MAP[kind].items():
            unit(f"{bname}.{torch_branch}", f"{bname}.{mine}")
    return _savez(out_path, out)


def convert_lpips_lins(sd, out_path):
    """pip `lpips` VGG state_dict -> lpips_vgg_lins.npz (lin{i}/w, the learned
    per-channel heads; keys lin{i}.model.1.weight with shape (1,C,1,1))."""
    out = {}
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                out[f"lin{i}/w"] = np.asarray(sd[key]).reshape(-1)
                break
    return _savez(out_path, out)


def convert_pose_resnet(sd, out_path, depth=152):
    """pose_resnet state_dict (the reference's pose_estimator submodule) ->
    pose_resnet_152.npz keyed for metrics/pose.py (BN eps 1e-5 folded)."""
    from ipoke_tpu_torch.metrics.pose import BOTTLENECK_LAYERS

    out = {}

    def conv_bn(conv_key, bn_key, out_key, transpose=conv2d_w):
        w = transpose(sd[f"{conv_key}.weight"])
        if f"{bn_key}.weight" in sd:
            w, b = _fold_bn(w, *_bn(sd, bn_key), eps=1e-5)
        else:
            b = np.asarray(sd.get(f"{conv_key}.bias", np.zeros(w.shape[-1], np.float32)))
        out[f"{out_key}.w"] = w
        out[f"{out_key}.b"] = b

    conv_bn("conv1", "bn1", "stem")
    for li, n_blocks in enumerate(BOTTLENECK_LAYERS[depth]):
        for bi in range(n_blocks):
            pre = f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                conv_bn(f"{pre}.conv{ci}", f"{pre}.bn{ci}", f"{pre}.conv{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1", f"{pre}.down")
    for di in range(3):
        conv_bn(f"deconv_layers.{di * 3}", f"deconv_layers.{di * 3 + 1}", f"deconv{di}",
                transpose=convT2d_w)
    out["head.w"] = conv2d_w(sd["final_layer.weight"])
    out["head.b"] = np.asarray(sd.get("final_layer.bias",
                                      np.zeros(out["head.w"].shape[-1], np.float32)))
    return _savez(out_path, out)
