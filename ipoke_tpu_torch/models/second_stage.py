"""Second stage (counterpart of ``ipoke_tpu/models/second_stage.py``).

  density (train): z_motion = motion encoder(video);
                   (gauss, logdet) = flow(z_motion, cond)
  sample:          z ~ N(0,1) -> flow^{-1}(z, cond) -> first-stage decode
  cond           = [conditioner(x0) mean, poke_embedder(poke)]

The first stage and the towers are frozen: they run under ``torch.no_grad``
where JAX stops their gradient.  ``init`` draws JAX's params from JAX's key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.models import encoders, first_stage, motion_encoder
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.nn.blocks import init_conv
from ipoke_tpu_torch.nn.core import conv2d, conv_transpose2d
from ipoke_tpu_torch.parallel.mesh import axis_index, axis_size
from ipoke_tpu_torch.utils import prng


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


def components(spec: SecondStageSpec):
    """The top-level keys of a second stage's params for ``spec``."""
    keys = ["flow", "first_stage", "poke_embedder"]
    if spec.use_cond:
        keys.append("conditioner")
    s = spec.first_stage.min_spatial_size
    if spec.poke_embedder.min_spatial_size != s:
        keys.append("conv_adapt_poke_emb")
    if spec.use_cond and spec.conditioner.min_spatial_size != s:
        keys.append("conv_adapt_cond")
    if spec.augment_channels:
        keys += ["scale_augment", "shift_augment"]
    return keys


def init(key, spec: SecondStageSpec, device=None, only=None):
    """Fresh params of every component, or of the components named in
    ``only``: each from its own subkey of ``split(key, 6)``, as JAX draws them,
    on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    if spec.augment_channels:
        raise NotImplementedError("augmented flow input is not ported yet (ROADMAP.md queue 1)")
    ks = prng.split(key, 6)
    s = spec.first_stage.min_spatial_size

    def adapter(k, wspec):   # grows by a transpose conv, shrinks by a strided conv
        return init_conv(k, 3, 3, wspec.nf_max, wspec.nf_max,
                         transposed=wspec.min_spatial_size < s, device=device)

    make = {
        "flow": lambda: transformer.init(ks[0], spec.flow, device),
        "first_stage": lambda: first_stage.init(ks[1], spec.first_stage, device),
        "poke_embedder": lambda: encoders.init_wrapper(ks[2], spec.poke_embedder, device),
        "conditioner": lambda: encoders.init_wrapper(ks[3], spec.conditioner, device),
        "conv_adapt_poke_emb": lambda: adapter(ks[4], spec.poke_embedder),
        "conv_adapt_cond": lambda: adapter(ks[5], spec.conditioner),
    }
    return {k: make[k]() for k in components(spec) if only is None or k in only}


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
    with torch.no_grad():
        poke_emb, _, _ = encoders.wrapper_encode(params["poke_embedder"], poke, spec.poke_embedder)
    if "conv_adapt_poke_emb" in params:
        poke_emb = _adapt(params["conv_adapt_poke_emb"], poke_emb,
                          spec.poke_embedder.min_spatial_size, spec.first_stage.min_spatial_size)
    if not spec.use_cond:
        return poke_emb
    with torch.no_grad():
        out, mean, _ = encoders.wrapper_encode(params["conditioner"], x0, spec.conditioner)
    cond = out if spec.conditioner.deterministic else mean
    if "conv_adapt_cond" in params:
        cond = _adapt(params["conv_adapt_cond"], cond,
                      spec.conditioner.min_spatial_size, spec.first_stage.min_spatial_size)
    return torch.cat([cond, poke_emb], dim=-1)


def encode_first_stage(params, spec: SecondStageSpec, x):
    """(motion, mu) of the frozen motion encoder, with the reference's choice
    of frames: all of them, except that a non-full-sequence first stage drops
    the last frame of 16 or more (full_seq) or the first frame (otherwise)."""
    fs = spec.first_stage
    if spec.full_seq:
        x_in = x if (fs.full_sequence or x.shape[1] < 16) else x[:, :-1]
    else:
        x_in = x if fs.full_sequence else x[:, 1:]
    with torch.no_grad():
        motion, mu, _ = motion_encoder.apply(params["first_stage"]["enc_motion"], x_in,
                                             fs.encoder_spec)
    return motion, mu


def forward_density(params, spec: SecondStageSpec, batch):
    """Training direction.  batch: {'images': (B,T,S,S,3), 'poke': (B,S,S,2)}.
    Returns (gaussianized, logdet, cond).  JAX's ``rng`` draws the augmented
    channels, which are not ported (``init`` raises on them)."""
    x = batch["images"]
    poke = batch["flow"] if spec.use_flow_as_poke else batch["poke"]
    cond = embed_cond(params, spec, x[:, 0], poke)
    flow_input, _ = encode_first_stage(params, spec, x)
    out, logdet = transformer.forward(params["flow"], spec.flow, flow_input, cond)
    return out, logdet, cond


def decode_first_stage(params, spec: SecondStageSpec, motion, x0, length: int):
    return first_stage.decode(params["first_stage"], motion, x0, spec.first_stage, length)


@torch.no_grad()
def forward_sample(params, spec: SecondStageSpec, batch, rng=None, n_samples: int = 1,
                   length: Optional[int] = None, add_first_frame: bool = False,
                   z: Optional[torch.Tensor] = None, mesh=None):
    """``n_samples`` stochastic videos for each batch element:
    (n_samples, B, T, S, S, 3).

    batch: {'images': (B,T,S,S,3), 'poke': (B,S,S,2)} (or 'flow' when the
    poke is a flow field).  ``z`` fixes the Gaussian draw, shape
    ``reverse_input_shape(...)`` or with a leading samples axis; else sample
    i draws ``prng.normal(keys[i], z_shape)`` in f32 from the JAX key ``rng``
    with ``keys = prng.split(rng, n_samples)``, JAX's draw.  The samples are
    folded into the batch axis.  Every op is per example, so a caller that
    fixes z per request gets outputs that do not depend on which other
    requests share the batch.

    With a ``mesh`` (``parallel/mesh``), ``batch`` holds this rank's rows of
    the global batch (``mesh.shard_batch``) and ``z`` (given, or drawn from
    ``rng``) is the global batch's: the rank takes its rows of it and
    returns its rows of the videos, which are the one-process videos' rows.
    """
    x = batch["images"]
    poke = batch["flow"] if spec.use_flow_as_poke else batch["poke"]
    x0 = x[:, 0]
    b = x.shape[0]
    if length is None:
        length = x.shape[1] - 1
    n_data, i = (1, 0) if mesh is None else (axis_size(mesh, "data"), axis_index(mesh, "data"))
    z_shape = transformer.reverse_input_shape(spec.flow, b * n_data, spec.latent_size,
                                              spec.flow_in_channels)
    if z is None:
        if rng is None:
            raise ValueError("forward_sample needs a fixed z or a JAX key rng")
        z = torch.stack([prng.normal(k, z_shape, x.device) for k in prng.split(rng, n_samples)])
    elif z.dim() == len(z_shape):
        z = z[None]
    if mesh is not None:   # this rank's rows of the global draw
        if tuple(z.shape[1:]) != tuple(z_shape):
            raise ValueError(f"z of shape {tuple(z.shape)} for a global batch of {z_shape}")
        z = z[:, i * b:(i + 1) * b]
        z_shape = (b,) + tuple(z_shape[1:])
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
