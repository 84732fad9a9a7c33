"""Conditioning towers (counterpart of ``ipoke_tpu/models/encoders.py``):
ConvEncoder / ConvDecoder / FirstStageWrapper.  The encoder is used frozen
at sampling as the poke embedder and the image conditioner; both halves are
trained by the image and poke AE trainers (``train/encoders.py``).

Spectral norm: with ``spectral_u=True`` the encoder's stem and strided
blocks and the decoder's ResBlocks carry a ``u`` beside their kernels, drawn
as JAX draws it (the draw consumes no split, so every other draw is the same
without it).  The decoder's upsampling blocks hold ``conv1`` and
``res_conv`` as transpose convs ``(in, out, kh, kw)``, normalised along axis
1; :func:`materialize_spectral_norm` and :func:`refresh_spectral_u` pick the
axis per node, as JAX's normalise every kernel along its O axis.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from ipoke_tpu_torch.nn import blocks
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


def init_conv_encoder(key, spec: ConvEncoderSpec, device="cpu", spectral_u=False):
    ks = prng.split(key, spec.n_stages + 3)
    sn = spectral_u and spec.spectral_norm
    nf = 32
    p = {"stem": init_conv2d_block(ks[0], spec.nf_in, nf, 3, norm=spec.norm, snorm=sn,
                                   device=device),
         "blocks": []}
    for n in range(spec.n_stages - 1):
        nf_out = min(nf * 2, spec.nf_max)
        p["blocks"].append(init_res_block(ks[1 + n], nf, nf_out, norm=spec.norm, stride=2,
                                          snorm=sn, device=device))
        nf = nf_out
    p["bottleneck"] = init_res_block(ks[spec.n_stages], nf, spec.nf_max, norm=spec.norm,
                                     device=device)
    if spec.variational:
        p["make_mu"] = init_norm_conv2d(ks[spec.n_stages + 1], 3, spec.nf_max, spec.nf_max, device)
        p["make_sigma"] = init_norm_conv2d(ks[spec.n_stages + 2], 3, spec.nf_max, spec.nf_max,
                                           device)
    return p


def conv_encoder_apply(params, x, spec: ConvEncoderSpec, rng=None, sample_prior=False):
    """Returns (out, mean, logstd).

    Deterministic: out is the bottleneck feature; mean the pre-bottleneck
    feature; logstd None.  Variational: mean/logstd from the NormConv2d heads
    (logstd sigmoid-squashed); out is ``normal(rng)`` with ``sample_prior``,
    else ``normal(rng) * exp(logstd) + mean`` when a JAX key ``rng`` is
    given (``utils/prng``, JAX's draw), else the mean.
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
        if rng is None and not sample_prior:
            out = mean
        else:
            eps = prng.normal(rng, tuple(mean.shape), mean.device).to(mean.dtype)
            out = eps if sample_prior else eps * torch.exp(logstd) + mean
    return out, mean, logstd


@dataclass(frozen=True)
class ConvDecoderSpec:
    nf_in: int
    in_channels: Tuple[int, ...]
    out_channels: int = 3
    n_skip_stages: int = 0
    norm: str = "group"
    spectral_norm: bool = True


def init_conv_decoder(key, spec: ConvDecoderSpec, device="cpu", spectral_u=False):
    ks = prng.split(key, len(spec.in_channels) + 2)
    sn = spectral_u and spec.spectral_norm
    p = {"in_block": init_res_block(ks[0], spec.nf_in, spec.in_channels[0], norm=spec.norm,
                                    snorm=sn, device=device),
         "blocks": []}
    for i, nf in enumerate(spec.in_channels[1:]):
        nf_in_dec = 2 * nf if i < spec.n_skip_stages else spec.in_channels[i]
        p["blocks"].append(init_res_block(ks[1 + i], nf_in_dec, nf, norm=spec.norm,
                                          upsampling=True, snorm=sn, device=device))
    p["out_conv"] = init_conv2d_block(ks[-1], spec.in_channels[-1], spec.out_channels, 3,
                                      norm="none", device=device)
    return p


def conv_decoder_apply(params, features, spec: ConvDecoderSpec):
    """features: list of encoder features, last = deepest.  Returns the
    decoded map, through tanh for 3 channels."""
    feats = list(features)
    x = res_block_apply(params["in_block"], feats.pop(), norm=spec.norm)
    for n, b in enumerate(params["blocks"]):
        if n < spec.n_skip_stages:
            x = torch.cat([x, feats.pop()], dim=-1)
        x = res_block_apply(b, x, norm=spec.norm, upsampling=True)
    act = "tanh" if spec.out_channels == 3 else "none"
    return conv2d_block_apply(params["out_conv"], x, stride=1, padding=1, norm="none", act=act)


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

    @property
    def decoder_spec(self):
        nf, depths = 32, [32]     # the encoder's stage widths, deepest first
        for _ in range(self.n_stages - 1):
            nf = min(nf * 2, self.nf_max)
            depths.insert(0, nf)
        return ConvDecoderSpec(nf_in=self.nf_max, in_channels=(self.nf_max,) + tuple(depths),
                               out_channels=self.nf_in)


def init_wrapper(key, spec: WrapperSpec, device="cpu", train=False):
    """The encoder from the first of ``split(key)``; with ``train`` also the
    decoder from the second and every ``u``, as JAX's ``init_wrapper``
    draws them (sampling needs the encoder alone)."""
    k1, k2 = prng.split(key)
    p = {"encoder": init_conv_encoder(k1, spec.encoder_spec, device, spectral_u=train)}
    if train:
        p["decoder"] = init_conv_decoder(k2, spec.decoder_spec, device, spectral_u=True)
    return p


def wrapper_encode(params, x, spec: WrapperSpec, rng=None):
    return conv_encoder_apply(params["encoder"], x, spec.encoder_spec, rng=rng)


def wrapper_apply(params, x, spec: WrapperSpec, rng=None):
    enc, *_ = wrapper_encode(params, x, spec, rng)
    return conv_decoder_apply(params["decoder"], [enc], spec.decoder_spec)


def _per_node(params, op):
    """``op(subtree, transposed=...)`` over a wrapper tree: the decoder's
    upsampling blocks hold conv1 and res_conv as transpose convs."""
    out = dict(params, encoder=op(params["encoder"]))
    if "decoder" in params:
        dec = params["decoder"]
        out["decoder"] = dict(dec, in_block=op(dec["in_block"]), blocks=[
            {k: op(v, transposed=k != "conv2") for k, v in b.items()} for b in dec["blocks"]])
    return out


def materialize_spectral_norm(params):
    """``nn/blocks.materialize_spectral_norm`` over a wrapper tree."""
    return _per_node(params, blocks.materialize_spectral_norm)


def refresh_spectral_u(params):
    """``nn/blocks.refresh_spectral_u`` (in place) over a wrapper tree."""
    _per_node(params, blocks.refresh_spectral_u)
