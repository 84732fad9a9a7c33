"""Conditioning towers (counterpart of ``ipoke_tpu/models/encoders.py``):
the ConvEncoder half of FirstStageWrapper, used frozen at sampling as the
poke embedder and the image conditioner.  The decoder half waits in ROADMAP
queue 1; ``init_wrapper`` splits its key as JAX does but draws only the
encoder.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ipoke_tpu_torch.nn.blocks import (
    conv2d_block_apply,
    init_conv2d_block,
    init_norm_conv2d,
    init_res_block,
    norm_conv2d_apply,
    res_block_apply,
)
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class ConvEncoderSpec:
    nf_in: int
    nf_max: int
    n_stages: int
    variational: bool = False
    norm: str = "group"
    spectral_norm: bool = True


def init_conv_encoder(key, spec: ConvEncoderSpec, device="cpu"):
    ks = prng.split(key, spec.n_stages + 3)
    nf = 32
    p = {"stem": init_conv2d_block(ks[0], spec.nf_in, nf, 3, norm=spec.norm, device=device),
         "blocks": []}
    for n in range(spec.n_stages - 1):
        nf_out = min(nf * 2, spec.nf_max)
        p["blocks"].append(init_res_block(ks[1 + n], nf, nf_out, norm=spec.norm, stride=2,
                                          device=device))
        nf = nf_out
    p["bottleneck"] = init_res_block(ks[spec.n_stages], nf, spec.nf_max, norm=spec.norm,
                                     device=device)
    if spec.variational:
        p["make_mu"] = init_norm_conv2d(ks[spec.n_stages + 1], 3, spec.nf_max, spec.nf_max, device)
        p["make_sigma"] = init_norm_conv2d(ks[spec.n_stages + 2], 3, spec.nf_max, spec.nf_max,
                                           device)
    return p


def conv_encoder_apply(params, x, spec: ConvEncoderSpec):
    """Returns (out, mean, logstd).

    Deterministic: out is the bottleneck feature; mean the pre-bottleneck
    feature; logstd None.  Variational: mean/logstd from the NormConv2d heads
    (logstd sigmoid-squashed) and out = mean, as sampling uses it (the
    reparametrised draw of training waits with the density direction).
    """
    act = "elu"
    out = conv2d_block_apply(params["stem"], x, stride=2, padding=1, norm=spec.norm, act=act)
    for b in params["blocks"]:
        out = res_block_apply(b, out, norm=spec.norm, act=act, stride=2)
    mean = out
    out = res_block_apply(params["bottleneck"], out, norm=spec.norm, act=act)
    logstd = None
    if spec.variational:
        mean = norm_conv2d_apply(params["make_mu"], out, padding=1)
        logstd = torch.sigmoid(norm_conv2d_apply(params["make_sigma"], out, padding=1))
        out = mean
    return out, mean, logstd


@dataclass(frozen=True)
class WrapperSpec:
    nf_in: int
    nf_max: int
    spatial_size: int
    min_spatial_size: int
    deterministic: bool
    poke_and_image: bool = False

    @property
    def n_stages(self):
        return int(math.log2(self.spatial_size // self.min_spatial_size))

    @property
    def encoder_spec(self):
        nf_in = self.nf_in + (3 if self.poke_and_image else 0)
        return ConvEncoderSpec(nf_in=nf_in, nf_max=self.nf_max, n_stages=self.n_stages,
                               variational=not self.deterministic)


def init_wrapper(key, spec: WrapperSpec, device="cpu"):
    k1, _ = prng.split(key)   # the second key is the decoder half's
    return {"encoder": init_conv_encoder(k1, spec.encoder_spec, device)}


def wrapper_encode(params, x, spec: WrapperSpec):
    return conv_encoder_apply(params["encoder"], x, spec.encoder_spec)
