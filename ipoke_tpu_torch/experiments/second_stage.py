"""Second-stage runs from a config and a checkpoint tree, for serving (the
port's copy of what ``-c/-m`` needs from ``ipoke_tpu/experiments``).

``build_spec_from_config`` assembles the spec as the JAX package does;
``load_for_serving`` finds the run's best checkpoint and the frozen
components its config names, and carries them across with
``ckpt/jax_bridge``.  Unlike the JAX package, which fills a component it
finds nowhere with fresh ``init`` params, the port raises and names it: it
has no ``init`` before its training slice.
"""
from __future__ import annotations

import os

from ipoke_tpu_torch import registry
from ipoke_tpu_torch.ckpt.io import datapath_rewrite, find_best
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage, load_npz
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec

# the keys a training run's checkpoint holds (``train/second_stage.py``)
TRAINABLE_KEYS = ("flow", "scale_augment", "shift_augment", "conv_adapt_poke_emb",
                  "conv_adapt_cond")
# the components a config may load from checkpoints of their own
FROZEN_KEYS = ("first_stage", "poke_embedder", "conditioner")


def build_spec_from_config(config, mcf_backend: str = "cuda_unit") -> SecondStageSpec:
    """The spec of a config: a registry architecture where ``first_stage``
    names one (``registry``, else the run's model name), or the explicit
    ``first_stage``/``poke_embedder``/``conditioner`` spec sections."""
    arch = dict(config["architecture"])
    data = config["data"]
    ss = data["spatial_size"]
    ss = ss[0] if isinstance(ss, (tuple, list)) else ss

    fs_cfg = config["first_stage"]
    if "spec" in fs_cfg:
        s = fs_cfg["spec"]
        fs_spec = FirstStageSpec(
            z_dim=s["z_dim"], spatial_size=ss, max_frames=data["max_frames"],
            enc_channels=tuple(s["ENC_M_channels"]), dec_channels=tuple(s["dec_channels"]),
            n_gru_layers=s.get("n_gru_layers", 4),
            min_spatial_size=s.get("min_spatial_size", 8),
            motion_bias=s.get("motion_bias", True), full_sequence=s.get("full_seq", True),
        )
    else:
        entry = registry.MODELS[fs_cfg.get("registry", config["general"].get("model_name"))]
        fs_spec = registry.build_specs(entry).first_stage

    def wrapper(section, nf_in, deterministic):
        spec_cfg = config.get(section, {}).get("spec", {})
        return WrapperSpec(
            nf_in=nf_in,
            nf_max=spec_cfg.get("nf_max", 64),
            spatial_size=ss,
            min_spatial_size=spec_cfg.get("min_spatial_size", 8),
            deterministic=deterministic,
            poke_and_image=spec_cfg.get("poke_and_image", False),
        )

    poke_spec = wrapper("poke_embedder", 2, True)
    cond_spec = (wrapper("conditioner", 3, False)
                 if config.get("conditioner", {}).get("use", True) else None)
    full_seq = config.get("training", {}).get("full_seq", True)
    return SecondStageSpec.build(arch, fs_spec, poke_spec, cond_spec, full_seq=full_seq,
                                 mcf_backend=mcf_backend).validate()


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


def version_dir(ckpt_root):
    """The version directory a test or serving run reads: the newest integer
    directory under ``ckpt_root`` that holds a checkpoint, else the newest,
    else ``0``."""
    existing = ([int(d) for d in os.listdir(ckpt_root) if d.isdigit()]
                if os.path.isdir(ckpt_root) else [])
    if not existing:
        return os.path.join(ckpt_root, "0")
    with_ckpt = [v for v in sorted(existing, reverse=True)
                 if find_best(os.path.join(ckpt_root, str(v)))]
    return os.path.join(ckpt_root, str(with_ckpt[0] if with_ckpt else max(existing)))


def load_for_serving(config, dirs, device=None):
    """(params, spec) of a run: the frozen components from the checkpoints
    the config names, then the trainable keys of the run's best checkpoint
    over them (a full-model checkpoint gives every component it holds).
    Raises ``FileNotFoundError`` naming each component found nowhere."""
    spec = build_spec_from_config(config)
    tree = {}
    for key in FROZEN_KEYS:
        path = config.get(key, {}).get("ckpt")
        if path and os.path.exists(path):
            loaded, _ = load_npz(datapath_rewrite(path))
            tree[key] = loaded.get(key, loaded)
    wanted = components(spec)
    best = find_best(version_dir(dirs["ckpt"]))
    if best:
        saved, _ = load_npz(best)
        saved = saved.get("params", saved)   # a TrainState dict: {step, params, opt_state}
        loaded = {k: v for k, v in saved.items() if k in TRAINABLE_KEYS}
        if not loaded:   # a full-model checkpoint
            loaded = {k: v for k, v in saved.items() if k in wanted}
        tree.update(loaded)
    missing = [k for k in wanted if k not in tree]
    if missing:
        raise FileNotFoundError(
            f"no checkpoint holds {missing} (best checkpoint: {best}; frozen "
            f"components from the config's first_stage/poke_embedder/conditioner "
            f"'ckpt' paths); the port has no fresh init to fill them")
    return bridge_second_stage(tree, spec, device), spec
