"""Second-stage runs from a config (the port's counterpart of
``ipoke_tpu/experiments/second_stage.py`` and of ``Experiment.fit`` in
``ipoke_tpu/experiments/base.py``).

``build_spec_from_config`` assembles the spec as the JAX package does;
``init_params`` takes the frozen components from the checkpoints the config
names and draws the rest with ``models/second_stage.init`` from the config's
seed, as JAX's ``_init_params`` does; ``load_for_serving`` lays the run's
best checkpoint over them; ``train`` trains the flow.

    python -m ipoke_tpu_torch.experiments.second_stage train -c <cfg> -m <name> \
        [--max-steps N] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch import registry, resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage, unbridge_second_stage
from ipoke_tpu_torch.data.synthetic import from_data_config, train_batches
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng

log = logging.getLogger(__name__)

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


def version_dir(ckpt_root):
    """The version directory a test or serving run reads: the newest integer
    directory under ``ckpt_root`` that holds a checkpoint, else the newest,
    else ``0``."""
    existing = ([int(d) for d in os.listdir(ckpt_root) if d.isdigit()]
                if os.path.isdir(ckpt_root) else [])
    if not existing:
        return os.path.join(ckpt_root, "0")
    with_ckpt = [v for v in sorted(existing, reverse=True)
                 if io.find_best(os.path.join(ckpt_root, str(v)))]
    return os.path.join(ckpt_root, str(with_ckpt[0] if with_ckpt else max(existing)))


def _seed(config):
    return int(config["general"].get("seed", 42))


def _bridge_and_fill(tree, config, spec, device):
    """``tree`` (numpy, JAX layout) in the port's layout, each component it
    lacks drawn fresh from the config's seed."""
    params = bridge_second_stage(tree, spec, device)
    missing = [k for k in second_stage.components(spec) if k not in params]
    if missing:
        log.warning("no checkpoint holds %s: fresh init from seed %d", missing, _seed(config))
        params.update(second_stage.init(prng.prng_key(_seed(config)), spec, device, only=missing))
    return params


def _frozen_from_config(config):
    """The frozen components the config's ``ckpt`` paths name (numpy, JAX layout)."""
    tree = {}
    for key in FROZEN_KEYS:
        path = config.get(key, {}).get("ckpt")
        if path and os.path.exists(path):
            loaded, _ = io.load(io.datapath_rewrite(path))
            tree[key] = loaded.get(key, loaded)
            log.info("loaded frozen %s from %s", key, path)
    return tree


def init_params(config, spec, device=None):
    """The params a training run starts from: the frozen components from the
    config's checkpoints, every other one from ``init(prng_key(seed))``."""
    return _bridge_and_fill(_frozen_from_config(config), config, spec, resolve_device(device))


def load_for_serving(config, dirs, device=None):
    """(params, spec) of a run: the frozen components from the checkpoints
    the config names, then the trainable keys of the run's best checkpoint
    over them (a full-model checkpoint gives every component it holds); a
    component found nowhere is drawn fresh from the config's seed."""
    device = resolve_device(device)
    spec = build_spec_from_config(config)
    tree = _frozen_from_config(config)
    best = io.find_best(version_dir(dirs["ckpt"]))
    if best:
        saved, _ = io.load(best)
        saved = saved.get("params", saved)   # a TrainState dict: {step, params, opt_state}
        loaded = {k: v for k, v in saved.items() if k in train_ss.TRAINABLE_KEYS}
        if not loaded:   # a full-model checkpoint
            loaded = {k: v for k, v in saved.items() if k in second_stage.components(spec)}
        tree.update(loaded)
        log.info("loaded checkpoint %s (%s)", best, sorted(loaded))
    return _bridge_and_fill(tree, config, spec, device), spec


def new_version_dir(ckpt_root):
    """A fresh training run's version directory: one past the newest."""
    existing = ([int(d) for d in os.listdir(ckpt_root) if d.isdigit()]
                if os.path.isdir(ckpt_root) else [])
    path = os.path.join(ckpt_root, str(max(existing) + 1 if existing else 0))
    os.makedirs(path, exist_ok=True)
    return path


def ckpt_tree(state, optimizer, spec):
    """The train state as JAX's ``_ckpt_tree`` holds it: step, the trainable
    params in JAX's layout, and the optimizer state under the port's keys
    (moments in the params' layout)."""
    opt = {name: {k: (unbridge_second_stage(v, spec) if isinstance(v, dict) else np.asarray(v))
                  for k, v in s.items()}
           for name, s in optimizer.state_tree(state.opt_state, state.params).items()}
    return {"step": np.asarray(state.step, np.int32),
            "params": unbridge_second_stage(state.params, spec), "opt_state": opt}


def _to_device(batch, device):
    return {k: torch.from_numpy(batch[k]).to(device) for k in ("images", "poke", "flow")}


def train(config, dirs, device=None, max_steps=None):
    """Train the flow as ``SecondStageExperiment.train`` does, on the
    synthetic dataset, and save ``last.npz`` in JAX's layout at the end.

    Params from ``init_params``; ``make_optimizer`` from the ``training``
    section; ``min_acc_batch_size`` sets the microbatches; the key of step i
    is ``rng, sub = split(rng)`` from ``prng_key(seed)``.  Validation by FVD
    waits for the metrics (ROADMAP queue 1 item 6), so no top-k checkpoints
    are kept, only ``last.npz``.  ``max_steps`` stops early.

    Returns a dict: ``state``, ``frozen``, ``spec``, ``ckpt`` (the path of
    last.npz), ``init_s``, ``save_s`` and ``history`` (per step: its metrics
    as floats and ``step_s``, host seconds to a synchronised device).
    """
    device = resolve_device(device)
    cfg_t = config.setdefault("training", {})
    if config["general"].get("debug"):   # the JAX experiment's debug shrink
        cfg_t["max_batches_per_epoch"] = 10
    spec = build_spec_from_config(config)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = init_params(config, spec, device)
    sync()
    init_s = time.perf_counter() - t0
    trainable, frozen = train_ss.split_params(params)
    steps_per_epoch = int(cfg_t.get("max_batches_per_epoch", 2000))
    n_epochs = int(cfg_t.get("n_epochs", 100))
    opt = train_ss.make_optimizer(
        lr=float(cfg_t.get("lr", 1e-3)),
        weight_decay=float(cfg_t.get("weight_decay", 1e-5)),
        warmup_steps=int(cfg_t.get("lr_scaling_max_it", 500)),
        total_steps=n_epochs * steps_per_epoch,
        clip_grad_norm=float(cfg_t.get("clip_grad_norm", 0.0)),
        use_adabelief=bool(cfg_t.get("use_adabelief", cfg_t.get("adabelief", False))),
        use_adamw=bool(cfg_t.get("use_adamw", False)),
        amsgrad=bool(cfg_t.get("amsgrad", False)),
    )
    state = train_ss.init_state(trainable, opt)
    data_cfg = config["data"]
    batch_size = int(data_cfg.get("batch_size", 8))
    min_acc = int(cfg_t.get("min_acc_batch_size", 0))
    n_micro = max(1, -(-min_acc // batch_size)) if min_acc > batch_size else 1
    step_fn = train_ss.make_train_step(
        spec, frozen, opt, spatial_mean=bool(cfg_t.get("spatial_mean", False)),
        logdet_weight=float(cfg_t.get("logdet_weight", 1.0)), n_microbatches=n_micro)
    batches = train_batches(from_data_config(data_cfg), batch_size, seed=int(data_cfg.get("seed", 0)))
    rng = prng.prng_key(_seed(config))
    total = n_epochs * steps_per_epoch if max_steps is None else min(max_steps, n_epochs * steps_per_epoch)
    history = []
    for _ in range(total):
        batch = _to_device(next(batches), device)
        rng, sub = prng.split(rng)
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, sub)
        sync()
        history.append(dict({k: float(v) for k, v in metrics.items()},
                            step_s=time.perf_counter() - t0))
        log.info("step %d: %s", state.step, " ".join(
            f"{k}={v:.4f}" for k, v in list(history[-1].items())[:4]))
    ckpt = os.path.join(new_version_dir(dirs["ckpt"]), "last.npz")
    t0 = time.perf_counter()
    io.save(ckpt, ckpt_tree(state, opt, spec), metadata={"step": state.step})
    return {"state": state, "frozen": frozen, "spec": spec, "ckpt": ckpt, "init_s": init_s,
            "save_s": time.perf_counter() - t0, "history": history}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.experiments.second_stage")
    ap.add_argument("command", choices=["train"])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from ipoke_tpu_torch.config import load_parameters

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    cfg, dirs = load_parameters(args.config, args.model)
    run = train(cfg, dirs, device=device, max_steps=args.max_steps)
    last = run["history"][-1] if run["history"] else {}
    print(f"trained {run['state'].step} steps on {device}; last flow_loss "
          f"{last.get('flow_loss', float('nan')):.4f}; saved {run['ckpt']}", flush=True)


if __name__ == "__main__":
    main()
