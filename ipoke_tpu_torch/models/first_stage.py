"""First-stage video autoencoder (counterpart of ``ipoke_tpu/models/first_stage.py``).

encode: video --3D ResNet (``models/motion_encoder``)--> motion latent.
decode: motion latent + start frame --ConvGRU + SPADE decoder--> frames.
forward: both, the autoencoding pass of stage-1 training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ipoke_tpu_torch.models import conv_gru, decoder, motion_encoder
from ipoke_tpu_torch.models.decoder import SpadeDecoderSpec
from ipoke_tpu_torch.models.motion_encoder import MotionEncoderSpec
from ipoke_tpu_torch.nn import blocks
from ipoke_tpu_torch.utils import prng

DECODE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclass(frozen=True)
class FirstStageSpec:
    z_dim: int
    spatial_size: int
    max_frames: int
    enc_channels: Tuple[int, ...]
    dec_channels: Tuple[int, ...]
    n_gru_layers: int = 4
    min_spatial_size: int = 8
    motion_bias: bool = True
    full_sequence: bool = True
    deterministic: bool = False
    norm: str = "group"
    spectral_norm: bool = True
    # dtype of the SPADE frame decoder ("f32" | "bf16"); the GRU stays f32
    decode_dtype: str = "f32"

    @property
    def encoder_spec(self) -> MotionEncoderSpec:
        return MotionEncoderSpec(
            channels=tuple(self.enc_channels), z_dim=self.z_dim,
            spatial_size=self.spatial_size, max_frames=self.max_frames,
            min_spatial_size=self.min_spatial_size, full_seq=self.full_sequence,
            deterministic=self.deterministic,
        )

    @property
    def decoder_spec(self) -> SpadeDecoderSpec:
        return SpadeDecoderSpec(
            z_dim=self.z_dim, dec_channels=tuple(self.dec_channels),
            spatial_size=self.spatial_size, min_spatial_size=self.min_spatial_size,
            norm=self.norm, spectral_norm=self.spectral_norm,
        )


def init(key, spec: FirstStageSpec, device="cpu", spectral_u=False):
    """``spectral_u``: the decoder's spectral-normed convs carry their ``u``
    (training); sampling needs none."""
    ks = prng.split(key, 4)
    p = {
        "enc_motion": motion_encoder.init(ks[0], spec.encoder_spec, device),
        "rnn": conv_gru.init_stack(ks[1], spec.z_dim, spec.z_dim, spec.n_gru_layers, device=device),
        "gen": decoder.init(ks[2], spec.decoder_spec, device, spectral_u=spectral_u),
    }
    if spec.motion_bias:
        s = spec.min_spatial_size
        p["motion_bias"] = prng.normal(ks[3], (1, s, s, spec.z_dim), device)
    return p


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def materialize_spectral_norm(params):
    """``nn/blocks.materialize_spectral_norm`` over a generator tree: the
    first stage's, or a variant's of ``models/variants`` (PokeVAE, RNN, FC
    baseline).  The upsampling blocks of its decoder (``gen``, or the FC
    baseline's top-level ``blocks``) hold conv1 and res_conv as transpose
    convs, normalised along their out axis; every other conv that carries a
    ``u`` (the PokeVAE's poke encoder, the RNN model's static encoder) along
    axis 0."""
    sn = blocks.materialize_spectral_norm

    def ups(bl):
        return [{k: sn(v, transposed=k != "conv2") for k, v in b.items()} for b in bl]

    out = {}
    for k, v in params.items():
        if k == "gen":
            out[k] = {n: ups(x) if n == "blocks" else sn(x) for n, x in v.items()}
        else:
            out[k] = ups(v) if k == "blocks" else sn(v)
    return out


def encode(params, x, spec: FirstStageSpec, rng=None):
    """x: (B,T,S,S,3) -> (motion, mu, logvar), each (B,s,s,z); the motion
    drawn from ``rng`` (a JAX key) unless the spec is deterministic.  All T
    frames with ``full_sequence``, else frames 1..T-1."""
    x_in = x if spec.full_sequence else x[:, 1:]
    return motion_encoder.apply(params["enc_motion"], x_in, spec.encoder_spec, rng=rng)


def decode(params, motion, start_frame, spec: FirstStageSpec, length: int,
           remat_body: bool = False):
    """Unroll ``length`` frames from a motion latent and a start frame.

    motion: (B,s,s,z); start_frame: (B,S,S,3) -> (B,length,S,S,3) in
    motion's dtype.  The GRU starts from ``[motion] * n_gru_layers`` and reads
    the broadcast ``motion_bias`` as its input at every step.  ``remat_body``:
    each frame's decoder runs under activation checkpointing, so its backward
    recomputes one frame's activations instead of keeping every frame's.
    """
    dec_spec = spec.decoder_spec
    b = start_frame.shape[0]
    hidden = [motion] * spec.n_gru_layers
    if spec.motion_bias:
        bias = params["motion_bias"].to(motion.dtype)
        in_rnn = bias.expand((b,) + tuple(bias.shape[1:]))
    else:
        in_rnn = motion
    dtype = DECODE_DTYPES[spec.decode_dtype]
    gen = _cast_floats(params["gen"], dtype)
    start_frame = start_frame.to(dtype)
    spade_feats = decoder.precompute_spade_feats(gen, start_frame, dec_spec)
    frames = []
    for _ in range(length):
        hidden = conv_gru.stack_apply(params["rnn"], in_rnn, hidden)
        args = (gen, hidden[-1].to(dtype), start_frame, dec_spec, spade_feats)
        frames.append(checkpoint(decoder.apply, *args, use_reentrant=False) if remat_body
                      else decoder.apply(*args))
    return torch.stack(frames, dim=1).to(motion.dtype)


def forward(params, x, spec: FirstStageSpec, rng=None, remat_decode: bool = False):
    """The autoencoding pass of training: (x_hat (B,T-1,S,S,3), mu, logvar)."""
    motion, mu, logvar = encode(params, x, spec, rng=rng)
    x_hat = decode(params, motion, x[:, 0], spec, length=x.shape[1] - 1, remat_body=remat_decode)
    return x_hat, mu, logvar
