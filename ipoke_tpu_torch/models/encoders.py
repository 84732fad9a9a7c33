"""Conditioning towers (counterpart of ``ipoke_tpu/models/encoders.py``):
the ConvEncoder half of FirstStageWrapper, used frozen at sampling as the
poke embedder and the image conditioner.  The decoder half waits in ROADMAP
queue 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ipoke_tpu_torch.nn.blocks import conv2d_block_apply, norm_conv2d_apply, res_block_apply


@dataclass(frozen=True)
class ConvEncoderSpec:
    nf_in: int
    nf_max: int
    n_stages: int
    variational: bool = False
    norm: str = "group"
    spectral_norm: bool = True


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


def wrapper_encode(params, x, spec: WrapperSpec):
    return conv_encoder_apply(params["encoder"], x, spec.encoder_spec)
