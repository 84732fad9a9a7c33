"""SPADE-conditioned frame decoder (counterpart of ``ipoke_tpu/models/decoder.py``).

The start-frame SPADE modulations are constant across the time unroll, so
``precompute_spade_feats`` computes them once per video.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ipoke_tpu_torch.nn.blocks import (
    conv2d_block_apply,
    init_conv2d_block,
    init_res_block,
    init_spade,
    res_block_apply,
    spade_apply,
    spade_modulation,
)
from ipoke_tpu_torch.utils import prng


@dataclass(frozen=True)
class SpadeDecoderSpec:
    z_dim: int
    dec_channels: Tuple[int, ...]
    spatial_size: int
    min_spatial_size: int = 8
    out_channels: int = 3
    n_skip_stages: int = 0
    norm: str = "group"
    spectral_norm: bool = True
    stacked_input: bool = False

    @property
    def n_stages(self):
        return len(self.dec_channels) - 1


def init(key, spec: SpadeDecoderSpec, device="cpu", spectral_u=False):
    """``spectral_u``: the res blocks carry their spectral-norm vectors ``u``
    (when ``spec.spectral_norm``), as training needs them."""
    ks = prng.split(key, 2 * spec.n_stages + 2)
    nf_in = 2 * spec.z_dim if spec.stacked_input else spec.z_dim
    ch = spec.dec_channels
    snorm = spectral_u and spec.spectral_norm
    return {
        "in_block": init_res_block(ks[0], nf_in, ch[0], norm=spec.norm, snorm=snorm,
                                   device=device),
        "blocks": [init_res_block(ks[1 + i], 2 * nf if i < spec.n_skip_stages else ch[i], nf,
                                  norm="none", upsampling=True, snorm=snorm, device=device)
                   for i, nf in enumerate(ch[1:])],
        "spades": [init_spade(ks[1 + spec.n_stages + i], nf, device)
                   for i, nf in enumerate(ch[1:])],
        "out_conv": init_conv2d_block(ks[-1], ch[-1], spec.out_channels, 3, device=device),
    }


def stage_resolutions(spec: SpadeDecoderSpec):
    """Feature-map resolution after each upsampling block."""
    s = spec.min_spatial_size
    return [s * 2 ** (i + 1) for i in range(spec.n_stages)]


def precompute_spade_feats(params, start_frame, spec: SpadeDecoderSpec):
    """Per-stage SPADE modulation {'gamma','beta'} of the start frame."""
    return [spade_modulation(sp, start_frame, (res, res))
            for sp, res in zip(params["spades"], stage_resolutions(spec))]


def apply(params, hidden, start_frame, spec: SpadeDecoderSpec, spade_feats=None):
    """hidden: (B, s, s, z_dim) GRU top-layer state -> frame (B, S, S, 3)."""
    x = res_block_apply(params["in_block"], hidden, norm=spec.norm)
    for n, (b, sp) in enumerate(zip(params["blocks"], params["spades"])):
        x = res_block_apply(b, x, norm="none", upsampling=True)
        mod = spade_feats[n] if spade_feats is not None else None
        x = spade_apply(sp, x, start_frame, shared_mod=mod)
    act = "tanh" if spec.out_channels == 3 else "none"
    return conv2d_block_apply(params["out_conv"], x, stride=1, padding=1, norm="none", act=act)
