"""Released-model registry (the port's copy of ``ipoke_tpu/registry.py``):
architecture descriptions of the 8 reference checkpoints."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec


@dataclass(frozen=True)
class ModelEntry:
    name: str
    dataset: str
    spatial_size: int
    fs_z_dim: int
    flow_mid_channels_factor: int
    max_frames: int = 10
    nf_max_cond: int = 64
    nf_max_poke: int = 64
    min_spatial_size: int = 8
    num_steps: Tuple[int, ...] = (10, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 1, 1, 1)
    factor: int = 16
    fvd_reference: Optional[float] = None  # published FVD


MODELS = {
    "plants_128": ModelEntry("plants_128", "plants", 128, 64, 32, fvd_reference=63.06),
    "plants_64": ModelEntry("plants_64", "plants", 64, 32, 64, fvd_reference=56.59),
    "iper_128": ModelEntry("iper_128", "iper", 128, 32, 64, fvd_reference=74.53),
    "iper_64": ModelEntry("iper_64", "iper", 64, 32, 64, fvd_reference=81.49),
    "h36m_128": ModelEntry("h36m_128", "human36m", 128, 64, 32, fvd_reference=119.77),
    "h36m_64": ModelEntry("h36m_64", "human36m", 64, 64, 32, fvd_reference=111.55),
    "taichi_128": ModelEntry("taichi_128", "taichi", 128, 32, 64, fvd_reference=100.69),
    "taichi_64": ModelEntry("taichi_64", "taichi", 64, 32, 64, fvd_reference=96.09),
}

FLAGSHIP = "iper_128"


def default_enc_channels(spatial_size: int) -> Tuple[int, ...]:
    return (64, 128, 256, 256, 256) if spatial_size == 128 else (64, 128, 256, 256)


def default_dec_channels(spatial_size: int) -> Tuple[int, ...]:
    return (256, 256, 256, 128, 64) if spatial_size == 128 else (256, 256, 128, 64)


def build_specs(entry: ModelEntry, mcf_backend: str = "cuda_unit",
                arch_overrides: Optional[dict] = None) -> SecondStageSpec:
    """SecondStageSpec wired like the reference constructor.  The MCF inverses
    default to kernel K2 (``'cuda_unit'``), which takes its plain version on
    CPU tensors.  ``arch_overrides`` sets keys of the ``architecture:``
    section on top of the entry's (a variant: ``augmented_input``,
    ``multistack``, ``attention``, ...)."""
    fs = FirstStageSpec(
        z_dim=entry.fs_z_dim,
        spatial_size=entry.spatial_size,
        max_frames=entry.max_frames,
        enc_channels=default_enc_channels(entry.spatial_size),
        dec_channels=default_dec_channels(entry.spatial_size),
        n_gru_layers=4,
        min_spatial_size=entry.min_spatial_size,
        motion_bias=True,
        full_sequence=True,
    )
    poke = WrapperSpec(nf_in=2, nf_max=entry.nf_max_poke, spatial_size=entry.spatial_size,
                       min_spatial_size=entry.min_spatial_size, deterministic=True)
    cond = WrapperSpec(nf_in=3, nf_max=entry.nf_max_cond, spatial_size=entry.spatial_size,
                       min_spatial_size=entry.min_spatial_size, deterministic=False)
    arch = {
        "num_steps": list(entry.num_steps),
        "factor": entry.factor,
        "flow_mid_channels_factor": entry.flow_mid_channels_factor,
        "kernel_size": (2, 3),
        "transform": "affine",
        "prior_transform": "affine",
        "activation": "elu",
        "condition_nice": False,
        "augmented_input": False,
        **(arch_overrides or {}),
    }
    return SecondStageSpec.build(arch, fs, poke, cond, full_seq=True, mcf_backend=mcf_backend)
