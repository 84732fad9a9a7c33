"""First-stage video autoencoder, decode half (counterpart of
``ipoke_tpu/models/first_stage.py``).

decode: motion latent + start frame --ConvGRU + SPADE decoder--> frames.
The 3D-ResNet encoder waits in ROADMAP queue 1 (density direction).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ipoke_tpu_torch.models import conv_gru, decoder
from ipoke_tpu_torch.models.decoder import SpadeDecoderSpec
from ipoke_tpu_torch.models.motion_encoder import MotionEncoderSpec

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


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def decode(params, motion, start_frame, spec: FirstStageSpec, length: int):
    """Unroll ``length`` frames from a motion latent and a start frame.

    motion: (B,s,s,z); start_frame: (B,S,S,3) -> (B,length,S,S,3) in
    motion's dtype.  The GRU starts from ``[motion] * n_gru_layers`` and reads
    the broadcast ``motion_bias`` as its input at every step.
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
        frames.append(decoder.apply(gen, hidden[-1].to(dtype), start_frame, dec_spec, spade_feats))
    return torch.stack(frames, dim=1).to(motion.dtype)
