"""The port's side of a cell: its specs built from a configuration file
through the port's own registry."""
from __future__ import annotations

from dataclasses import replace

from portbench.reference.sample import level_channels


def port_spec(cfg):
    """The port's ``SecondStageSpec`` for the configuration, built through its
    registry; raises where the port's derived sizes differ from the file's."""
    from ipoke_tpu_torch import registry
    fs, fl = cfg["first_stage"], cfg["flow"]
    entry = registry.ModelEntry(
        cfg["name"], "benchmark", fs["spatial_size"], fs["z_dim"], fl["flow_mid_channels_factor"],
        max_frames=fs["max_frames"], nf_max_cond=cfg["conditioner"]["nf_max"],
        nf_max_poke=cfg["poke_embedder"]["nf_max"], min_spatial_size=fs["min_spatial_size"],
        num_steps=tuple(fl["num_steps"]), factor=fl["factor"])
    spec = registry.build_specs(entry, mcf_backend=cfg["mcf_backend"])
    spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype=cfg["decode_dtype"]))
    got = (list(spec.first_stage.enc_channels), list(spec.first_stage.dec_channels),
           spec.flow.level_channels(), spec.h_channels)
    want = (fs["enc_channels"], fs["dec_channels"], level_channels(cfg),
            cfg["poke_embedder"]["nf_max"] + cfg["conditioner"]["nf_max"])
    if got != want:
        raise ValueError(f"portbench: the port builds {got} for {cfg['name']}, the file says {want}")
    return spec.validate()
