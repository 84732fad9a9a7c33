"""Second stage, sampling direction (counterpart of
``ipoke_tpu/models/second_stage.py``).

  sample:  z ~ N(0,1) -> flow^{-1}(z, cond) -> first-stage decode
  cond   = [conditioner(x0) mean, poke_embedder(poke)]

The density direction (training) waits in ROADMAP queue 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.models import encoders, first_stage
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.nn.core import conv2d, conv_transpose2d


@dataclass(frozen=True)
class SecondStageSpec:
    flow: FlowSpec
    first_stage: FirstStageSpec
    poke_embedder: WrapperSpec
    conditioner: Optional[WrapperSpec]  # None when conditioner.use == False
    augment_channels: int = 0           # >0 when augmented_input
    scale_augmentation: bool = True
    shift_augmentation: bool = True
    poke_and_image: bool = False
    use_flow_as_poke: bool = False      # poke_key == 'flow'
    full_seq: bool = True

    @property
    def use_cond(self) -> bool:
        return self.conditioner is not None

    @property
    def flow_in_channels(self) -> int:
        return self.first_stage.z_dim + self.augment_channels

    @property
    def h_channels(self) -> int:
        return self.poke_embedder.nf_max + (self.conditioner.nf_max if self.use_cond else 0)

    @property
    def latent_size(self) -> int:
        return self.first_stage.min_spatial_size

    def validate(self) -> "SecondStageSpec":
        """Raise on a motion latent that the encoder would not produce, or a
        decoder that would not reach the data's spatial size."""
        _, _, stride4, has_l4, has_l5, _ = self.first_stage.encoder_spec.derived()
        div = 8
        if has_l4 and stride4 is not None and stride4[-1] == 2:
            div *= 2
        if has_l5:
            div *= 2
        fs = self.first_stage
        latent = fs.spatial_size // div
        if latent != fs.min_spatial_size:
            raise ValueError(
                f"first_stage.min_spatial_size={fs.min_spatial_size} but the motion "
                f"encoder produces a {latent}x{latent} latent for "
                f"spatial_size={fs.spatial_size} (divides by {div}); "
                f"set min_spatial_size={latent} or adjust spatial_size")
        n_stages = fs.decoder_spec.n_stages
        out_spatial = fs.min_spatial_size * 2 ** n_stages
        if out_spatial != fs.spatial_size:
            need = int(math.log2(fs.spatial_size // fs.min_spatial_size)) + 1
            raise ValueError(
                f"dec_channels has {n_stages} upsampling stages -> "
                f"{out_spatial}x{out_spatial} frames, but data spatial_size is "
                f"{fs.spatial_size}; dec_channels needs {need} entries")
        return self

    @classmethod
    def build(cls, arch: dict, first_stage_spec: FirstStageSpec, poke_spec: WrapperSpec,
              cond_spec: Optional[WrapperSpec], full_seq: bool = True,
              mcf_backend: str = "scan") -> "SecondStageSpec":
        """Derive the flow dims the way the reference constructor does."""
        augment = int(arch.get("augment_channels", 0)) if arch.get("augmented_input") else 0
        flow_in = first_stage_spec.z_dim + augment
        arch = dict(arch)
        arch["flow_in_channels"] = flow_in
        arch["flow_mid_channels"] = int(arch["flow_mid_channels_factor"] * flow_in)
        arch["h_channels"] = poke_spec.nf_max + (cond_spec.nf_max if cond_spec else 0)
        return cls(
            flow=transformer.spec_from_config(arch, mcf_backend=mcf_backend),
            first_stage=first_stage_spec,
            poke_embedder=poke_spec,
            conditioner=cond_spec,
            augment_channels=augment,
            scale_augmentation=bool(arch.get("scale_augmentation", False)),
            shift_augmentation=bool(arch.get("shift_augmentation", False)),
            poke_and_image=bool(poke_spec.poke_and_image),
            full_seq=full_seq,
        )


def _adapt(p_conv, x, src_size, tgt_size):
    """Spatial-size adapter: strided conv when shrinking, transpose conv
    (weight ``(in, out, kh, kw)``) when growing."""
    if src_size == tgt_size:
        return x
    if src_size > tgt_size:
        return conv2d(x, p_conv["w"], p_conv.get("b"), stride=src_size // tgt_size, padding=1)
    return conv_transpose2d(x, p_conv["w"], p_conv.get("b"), stride=tgt_size // src_size,
                            padding=1, output_padding=1)


def embed_cond(params, spec: SecondStageSpec, x0, poke):
    """cond = cat([conditioner(x0) mean, poke_embedder(poke)]): (B, s, s, h_channels)."""
    if spec.poke_and_image:
        poke = torch.cat([poke, x0], dim=-1)
    poke_emb, _, _ = encoders.wrapper_encode(params["poke_embedder"], poke, spec.poke_embedder)
    if "conv_adapt_poke_emb" in params:
        poke_emb = _adapt(params["conv_adapt_poke_emb"], poke_emb,
                          spec.poke_embedder.min_spatial_size, spec.first_stage.min_spatial_size)
    if not spec.use_cond:
        return poke_emb
    out, mean, _ = encoders.wrapper_encode(params["conditioner"], x0, spec.conditioner)
    cond = out if spec.conditioner.deterministic else mean
    if "conv_adapt_cond" in params:
        cond = _adapt(params["conv_adapt_cond"], cond,
                      spec.conditioner.min_spatial_size, spec.first_stage.min_spatial_size)
    return torch.cat([cond, poke_emb], dim=-1)


def decode_first_stage(params, spec: SecondStageSpec, motion, x0, length: int):
    return first_stage.decode(params["first_stage"], motion, x0, spec.first_stage, length)


@torch.no_grad()
def forward_sample(params, spec: SecondStageSpec, batch, generator: Optional[torch.Generator] = None,
                   n_samples: int = 1, length: Optional[int] = None,
                   add_first_frame: bool = False, z: Optional[torch.Tensor] = None):
    """``n_samples`` stochastic videos for each batch element:
    (n_samples, B, T, S, S, 3).

    batch: {'images': (B,T,S,S,3), 'poke': (B,S,S,2)} (or 'flow' when the
    poke is a flow field).  ``z`` fixes the Gaussian draw, shape
    ``reverse_input_shape(...)`` or with a leading samples axis; else it is
    drawn from ``generator``.  The samples are folded into the batch axis.
    Every op is per example, so a caller that fixes z per request gets
    outputs that do not depend on which other requests share the batch.
    """
    x = batch["images"]
    poke = batch["flow"] if spec.use_flow_as_poke else batch["poke"]
    x0 = x[:, 0]
    b = x.shape[0]
    if length is None:
        length = x.shape[1] - 1
    z_shape = transformer.reverse_input_shape(spec.flow, b, spec.latent_size, spec.flow_in_channels)
    if z is None:
        if generator is None:
            raise ValueError("forward_sample needs a fixed z or a torch.Generator")
        z = torch.randn((n_samples,) + tuple(z_shape), generator=generator,
                        device=x.device, dtype=x.dtype)
    elif z.dim() == len(z_shape):
        z = z[None]
    n = z.shape[0]
    cond = embed_cond(params, spec, x0, poke)

    def rep(t):  # (B, ...) -> (n*B, ...), sample-major like z
        return t.unsqueeze(0).expand((n,) + tuple(t.shape)).reshape((n * b,) + tuple(t.shape[1:]))

    motion = transformer.reverse(params["flow"], spec.flow,
                                 z.to(x.dtype).reshape((n * b,) + tuple(z_shape[1:])), rep(cond))
    if spec.augment_channels:
        motion = motion[..., :-spec.augment_channels]
    x0r = rep(x0)
    vid = decode_first_stage(params, spec, motion, x0r, length)
    if add_first_frame:
        vid = torch.cat([x0r[:, None], vid], dim=1)
    return vid.reshape((n, b) + tuple(vid.shape[1:]))
