"""The first-stage model variants and the cVAE baseline (counterpart of
``ipoke_tpu/models/variants.py``).

RNNMotionModel: a static-scene ConvEncoder of the start frame feeds the GRU
  input, a res block after the GRU, a plain ConvDecoder (no SPADE).
FCBaseline: the motion latent pooled to a vector, a dense GRU and a
  fully connected 4x4 start block under SPADE res blocks.
PokeVAE (``architecture.baseline: poke_vae``): a ConvEncoder of the start
  frame and the poke drives the GRU input, or with ``stack_motion_and_poke``
  joins the motion in the GRU's hidden state (2 z_dim wide, zero input);
  ``sample_prior`` replaces the motion by N(0, 1).

Every init draws JAX's numbers from JAX's keys, the spectral-norm vectors
``u`` included (JAX's variant trees always carry them).  JAX's ``lax.scan``
over the frames is a loop here; the start frame's SPADE modulation is
computed once per video.  ``models/first_stage.materialize_spectral_norm``
normalises every one of these trees.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import torch

from ipoke_tpu_torch.models import conv_gru, decoder, encoders, motion_encoder
from ipoke_tpu_torch.models.decoder import SpadeDecoderSpec
from ipoke_tpu_torch.models.encoders import ConvDecoderSpec, ConvEncoderSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.nn import blocks
from ipoke_tpu_torch.utils import prng


def _n_stages(spatial_size, min_spatial_size):
    return int(math.log2(spatial_size // min_spatial_size))


# ---------------------------------------------------------------------------
# RNNMotionModel
# ---------------------------------------------------------------------------

def rnn_motion_specs(spec: FirstStageSpec):
    """(static encoder spec, decoder spec) of an RNN motion model."""
    return (ConvEncoderSpec(nf_in=3, nf_max=spec.z_dim,
                            n_stages=_n_stages(spec.spatial_size, spec.min_spatial_size)),
            ConvDecoderSpec(nf_in=spec.z_dim, in_channels=tuple(spec.dec_channels)))


def init_rnn_motion(key, spec: FirstStageSpec, device="cpu"):
    """(params, static encoder spec, decoder spec)."""
    ks = prng.split(key, 5)
    enc_static_spec, dec_spec = rnn_motion_specs(spec)
    z = spec.z_dim
    return {
        "enc_motion": motion_encoder.init(ks[0], spec.encoder_spec, device),
        "enc_static": encoders.init_conv_encoder(ks[1], enc_static_spec, device, spectral_u=True),
        "rnn": conv_gru.init_stack(ks[2], z, z, spec.n_gru_layers, device=device),
        "post_hidden": blocks.init_res_block(ks[3], z, z, norm="group", snorm=True,
                                             device=device),
        "gen": encoders.init_conv_decoder(ks[4], dec_spec, device, spectral_u=True),
    }, enc_static_spec, dec_spec


def rnn_motion_forward(params, x, spec: FirstStageSpec, enc_static_spec, dec_spec, rng=None):
    """x: (B,T,S,S,3) -> (frames (B,T-1,S,S,3), mu, logvar); the GRU reads
    the start frame's scene code first, then its own post-hidden feature."""
    scene, _, _ = encoders.conv_encoder_apply(params["enc_static"], x[:, 0], enc_static_spec)
    x_in = x if spec.full_sequence else x[:, 1:]
    motion, mu, logvar = motion_encoder.apply(params["enc_motion"], x_in, spec.encoder_spec,
                                              rng=rng)
    hidden, inp, frames = [motion] * spec.n_gru_layers, scene, []
    for _ in range(x.shape[1] - 1):
        hidden = conv_gru.stack_apply(params["rnn"], inp, hidden)
        inp = blocks.res_block_apply(params["post_hidden"], hidden[-1], norm="group")
        frames.append(encoders.conv_decoder_apply(params["gen"], [inp], dec_spec))
    return torch.stack(frames, dim=1), mu, logvar


# ---------------------------------------------------------------------------
# FCBaseline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FCBaselineSpec:
    z_dim: int
    spatial_size: int
    max_frames: int
    enc_channels: Tuple[int, ...]
    dec_channels: Tuple[int, ...]
    n_gru_layers: int = 2
    full_sequence: bool = True

    @property
    def encoder_spec(self) -> motion_encoder.MotionEncoderSpec:
        return motion_encoder.MotionEncoderSpec(
            channels=tuple(self.enc_channels), z_dim=self.z_dim, spatial_size=self.spatial_size,
            max_frames=self.max_frames, min_spatial_size=4, full_seq=self.full_sequence)


def init_fc_baseline(key, spec: FCBaselineSpec, device="cpu"):
    """(params, motion encoder spec)."""
    ks = prng.split(key, 6)
    d, ch = spec.z_dim, spec.dec_channels

    def gru_cell(k):
        lin = lambda kk: {"w": 0.05 * prng.normal(kk, (2 * d, d), device),  # noqa: E731
                          "b": torch.zeros(d, device=device)}
        k1, k2, k3 = prng.split(k, 3)
        return {"reset": lin(k1), "update": lin(k2), "out": lin(k3)}

    return {
        "enc_motion": motion_encoder.init(ks[0], spec.encoder_spec, device),
        "motion_bias": prng.normal(ks[1], (1, d), device),
        "rnn": [gru_cell(prng.fold_in(ks[2], i)) for i in range(spec.n_gru_layers)],
        "start_block": {"w": 0.05 * prng.normal(ks[3], (d, ch[0] * 16), device),
                        "b": torch.zeros(ch[0] * 16, device=device)},
        "blocks": [blocks.init_res_block(prng.fold_in(ks[4], i), ch[i], nf, norm="none",
                                         upsampling=True, snorm=True, device=device)
                   for i, nf in enumerate(ch[1:])],
        "spades": [blocks.init_spade(prng.fold_in(ks[5], i), nf, device)
                   for i, nf in enumerate(ch[1:])],
        "out_conv": blocks.init_conv2d_block(prng.fold_in(ks[5], 99), ch[-1], 3, 3, norm="none",
                                             device=device),
    }, spec.encoder_spec


def _dense_gru(cells, x, hidden):
    new, inp = [], x
    for cell, h in zip(cells, hidden):
        cat = torch.cat([inp, h], dim=-1)
        u = torch.sigmoid(cat @ cell["update"]["w"] + cell["update"]["b"])
        r = torch.sigmoid(cat @ cell["reset"]["w"] + cell["reset"]["b"])
        o = torch.tanh(torch.cat([inp, h * r], dim=-1) @ cell["out"]["w"] + cell["out"]["b"])
        inp = h * (1 - u) + o * u
        new.append(inp)
    return new


def fc_baseline_forward(params, x, spec: FCBaselineSpec, me_spec, rng=None):
    """The motion latent pooled to a vector, a dense GRU, and per frame the
    fully connected 4x4 start under SPADE res blocks: (frames, mu, logvar)."""
    x_in = x if spec.full_sequence else x[:, 1:]
    motion, mu, logvar = motion_encoder.apply(params["enc_motion"], x_in, me_spec, rng=rng)
    b, start_frame = x.shape[0], x[:, 0]
    hidden = [motion.mean(dim=(1, 2))] * spec.n_gru_layers
    in_rnn = params["motion_bias"].expand(b, spec.z_dim)
    sb = params["start_block"]
    mods = [blocks.spade_modulation(sp, start_frame, (4 * 2 ** (i + 1),) * 2)
            for i, sp in enumerate(params["spades"])]
    frames = []
    for _ in range(x.shape[1] - 1):
        hidden = _dense_gru(params["rnn"], in_rnn, hidden)
        feat = (hidden[-1] @ sb["w"] + sb["b"]).reshape(b, 4, 4, -1)
        for blk, sp, mod in zip(params["blocks"], params["spades"], mods):
            feat = blocks.res_block_apply(blk, feat, norm="none", upsampling=True)
            feat = blocks.spade_apply(sp, feat, start_frame, shared_mod=mod)
        frames.append(blocks.conv2d_block_apply(params["out_conv"], feat, padding=1, act="tanh"))
    return torch.stack(frames, dim=1), mu, logvar


# ---------------------------------------------------------------------------
# PokeVAE (the cVAE ablation baseline)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PokeVAESpec:
    first_stage: FirstStageSpec
    stack_motion_and_poke: bool = False

    @property
    def poke_enc_spec(self) -> ConvEncoderSpec:
        fs = self.first_stage
        return ConvEncoderSpec(nf_in=5, nf_max=fs.z_dim,
                               n_stages=_n_stages(fs.spatial_size, fs.min_spatial_size))

    @property
    def decoder_spec(self) -> SpadeDecoderSpec:
        return replace(self.first_stage.decoder_spec, stacked_input=self.stack_motion_and_poke)


def init_poke_vae(key, spec: PokeVAESpec, device="cpu"):
    fs = spec.first_stage
    ks = prng.split(key, 5)
    hidden_size = 2 * fs.z_dim if spec.stack_motion_and_poke else fs.z_dim
    s = fs.min_spatial_size
    return {
        "enc_motion": motion_encoder.init(ks[0], fs.encoder_spec, device),
        "poke_enc": encoders.init_conv_encoder(ks[1], spec.poke_enc_spec, device,
                                               spectral_u=True),
        "rnn": conv_gru.init_stack(ks[2], fs.z_dim, hidden_size, fs.n_gru_layers, device=device),
        "motion_bias": prng.normal(ks[3], (1, s, s, fs.z_dim), device),
        "gen": decoder.init(ks[4], spec.decoder_spec, device, spectral_u=True),
    }


def poke_vae_forward(params, batch, spec: PokeVAESpec, rng=None, sample_prior=False):
    """batch['images'] (B,T,S,S,3), batch['poke'] (B,S,S,2) -> (frames
    (B,T-1,S,S,3), mu, logvar); with ``sample_prior`` the motion is
    ``normal(rng)`` (a JAX key) and mu, logvar are None."""
    fs = spec.first_stage
    x, poke = batch["images"], batch["poke"]
    start_frame = x[:, 0]
    if sample_prior:
        s = fs.min_spatial_size
        motion = prng.normal(rng, (x.shape[0], s, s, fs.z_dim), x.device).to(x.dtype)
        mu = logvar = None
    else:
        x_in = x if fs.full_sequence else x[:, 1:]
        motion, mu, logvar = motion_encoder.apply(params["enc_motion"], x_in, fs.encoder_spec,
                                                  rng=rng)
    poke_repr, _, _ = encoders.conv_encoder_apply(
        params["poke_enc"], torch.cat([start_frame, poke.to(x.dtype)], dim=-1),
        spec.poke_enc_spec)
    if spec.stack_motion_and_poke:
        hidden = [torch.cat([motion, poke_repr], dim=-1)] * fs.n_gru_layers
        in_rnn = torch.zeros_like(poke_repr)
    else:
        hidden, in_rnn = [motion] * fs.n_gru_layers, poke_repr
    dec_spec = spec.decoder_spec
    spade_feats = decoder.precompute_spade_feats(params["gen"], start_frame, dec_spec)
    frames = []
    for _ in range(x.shape[1] - 1):
        hidden = conv_gru.stack_apply(params["rnn"], in_rnn, hidden)
        frames.append(decoder.apply(params["gen"], hidden[-1], start_frame, dec_spec,
                                    spade_feats))
    return torch.stack(frames, dim=1), mu, logvar
