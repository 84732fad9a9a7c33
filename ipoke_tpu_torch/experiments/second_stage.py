"""Second-stage runs from a config (the port's counterpart of
``ipoke_tpu/experiments/second_stage.py`` and of ``Experiment.fit`` in
``ipoke_tpu/experiments/base.py``).

``build_spec_from_config`` assembles the spec as the JAX package does;
``init_params`` takes the frozen components from the checkpoints the config
names and draws the rest with ``models/second_stage.init`` from the config's
seed, as JAX's ``_init_params`` does; ``load_for_serving`` lays the run's
best checkpoint over them; ``train`` trains the flow, validated by FVD with
the top-k checkpoints kept; ``test`` runs a test mode of
``eval/test_modes`` on the best checkpoint.

    python -m ipoke_tpu_torch.experiments.second_stage train -c <cfg> -m <name> \
        [--max-steps N] [--base_dir DIR] [--device cpu]
    python -m ipoke_tpu_torch.experiments.second_stage test -c <cfg> -m <name> \
        [--mode {samples,fvd,accuracy,diversity,control_sensitivity,transfer,kps_acc}] \
        [--base_dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch import registry, resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage, unbridge_second_stage
from ipoke_tpu_torch.ckpt.optax_layout import conform, from_optax, to_optax
from ipoke_tpu_torch.data.datamodule import StaticDataModule
from ipoke_tpu_torch.data.loader import to_device
from ipoke_tpu_torch.eval import test_modes
from ipoke_tpu_torch.experiments import base
from ipoke_tpu_torch.experiments.base import MONITOR, debug_shrink, fit, train_loader, version_dir
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.flows.loss import flow_loss
from ipoke_tpu_torch.metrics.fvd import FVDAccumulator
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.models.second_stage import SecondStageSpec
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng

log = logging.getLogger(__name__)

# the components a config may load from checkpoints of their own
FROZEN_KEYS = ("first_stage", "poke_embedder", "conditioner")
# the batch keys of SecondStageExperiment.datakeys that a step reads
BATCH_KEYS = ("images", "poke", "flow")
DATAKEYS = ("images", "poke", "flow", "sample_ids")


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


def ckpt_tree(state, optimizer, spec):
    """The train state as JAX's ``_ckpt_tree`` holds a ``TrainState`` (or,
    under ``training.chunked``, a ``ChunkedTrainState``): step, the trainable
    params in JAX's layout, and optax's ``opt_state`` (``ckpt/optax_layout``)."""
    export = lambda tree: unbridge_second_stage(tree, spec)   # noqa: E731
    return {"step": np.asarray(state.step, np.int32), "params": export(state.params),
            "opt_state": to_optax(optimizer, state.opt_state, state.params, export)}


def restore_train_state(tree, optimizer, template, spec, device=None):
    """``ckpt_tree``'s inverse: a ``TrainState`` on ``device`` from the tree
    of a JAX or a port ``last.npz``, its float leaves requiring grad.  The
    params must have ``template``'s keys and shapes (KeyError, ValueError),
    the optimizer state ``optimizer``'s chain (KeyError)."""
    device = resolve_device(device)
    bridge = lambda t: bridge_second_stage(t, spec, device)   # noqa: E731
    params = conform(template.params, bridge(tree["params"]))
    opt_state = from_optax(optimizer, tree["opt_state"], params, bridge)
    for p in train_ss.float_leaves(params):
        p.requires_grad_(True)
    return train_ss.TrainState(int(tree["step"]), params, opt_state)


@torch.no_grad()
def validate(params, spec, config, datamod, log_dir=None, timings=None):
    """``flow_loss-val`` and ``FVD-val`` over the first
    ``training.max_val_batches`` batches of the val split, as JAX's
    ``SecondStageExperiment.validate``: the density loss of each batch, and
    one sample per example on key ``split`` of ``prng_key(123)`` against the
    example's frames 1..T-1 (``logging.n_fvd_samples`` at most).  Then, as
    JAX's, the latent scatter (``log_latents``) to ``<log_dir>/latents.png``,
    the run's log directory (a run without one draws none); where it fails
    (no matplotlib) the validation logs "latent scatter skipped: ..." and
    returns its metrics all the same.  ``timings`` as in ``eval/test_modes``,
    with ``latents_s``."""
    device = test_modes.params_device(params)
    clock = test_modes.Clock(device, timings)
    acc = FVDAccumulator(n_samples=int(config.get("logging", {}).get("n_fvd_samples", 1000)),
                         device=device)
    losses = []
    rng = prng.prng_key(123)
    max_batches = int(config["training"].get("max_val_batches", 100))
    for bi, raw in enumerate(datamod.loader("val")):
        if bi >= max_batches:
            break
        batch = to_device(raw, device, BATCH_KEYS)
        out, logdet, _ = second_stage.forward_density(params, spec, batch)
        losses.append(float(flow_loss(out, logdet)[0]))
        rng, sub = prng.split(rng)
        t0 = time.perf_counter()
        fake = second_stage.forward_sample(params, spec, batch, sub, n_samples=1)[0]
        clock.add("sampling_s", t0)
        acc.update(batch["images"][:, 1:], fake)
    fvd_val = acc.compute() if acc._real else float("nan")
    clock.out["i3d_s"] = clock.out.get("i3d_s", 0.0) + acc.feature_s
    clock.out["frechet_s"] = clock.out.get("frechet_s", 0.0) + acc.frechet_s
    if log_dir is not None:
        t0 = time.perf_counter()
        try:
            log_latents(params, spec, datamod, os.path.join(log_dir, "latents.png"))
        except Exception as e:   # noqa: BLE001  (a plot must never stop training, as JAX's)
            log.warning("latent scatter skipped: %s", e)
        clock.add("latents_s", t0)
    return {"FVD-val": fvd_val, "flow_loss-val": float(np.mean(losses)) if losses else float("nan")}


@torch.no_grad()
def latent_samples(params, spec, datamod, n_batches=2):
    """The latents of JAX's ``_log_latents`` over the first ``n_batches``
    val batches (``max_val_batches`` does not apply): the motion encoder's
    posterior means, and flow samples ``reverse(z, cond)`` (K2 on the card)
    with z drawn in the latent's shape from ``split`` of ``prng_key(5)``,
    one key per batch.  Returns (means, samples), each (examples, features)
    numpy."""
    device = test_modes.params_device(params)
    z_post, z_samp = [], []
    rng = prng.prng_key(5)
    for bi, raw in enumerate(datamod.loader("val")):
        if bi >= n_batches:
            break
        batch = to_device(raw, device, BATCH_KEYS)
        motion, mu = second_stage.encode_first_stage(params, spec, batch["images"])
        z_post.append(mu.reshape(mu.shape[0], -1).float().cpu().numpy())
        cond = second_stage.embed_cond(params, spec, batch["images"][:, 0], batch["poke"])
        rng, sub = prng.split(rng)
        z = prng.normal(sub, tuple(motion.shape[:-1]) + (spec.flow_in_channels,), device)
        z_inn = transformer.reverse(params["flow"], spec.flow, z, cond)
        z_samp.append(z_inn.reshape(z.shape[0], -1).float().cpu().numpy())
    return np.concatenate(z_post), np.concatenate(z_samp)


def log_latents(params, spec, datamod, path, n_batches=2):
    """JAX's ``_log_latents``: ``latent_samples`` as a 2-D scatter
    (``utils/logging.latent_scatter``, matplotlib) at ``path``."""
    from ipoke_tpu_torch.utils.logging import latent_scatter

    z_post, z_samp = latent_samples(params, spec, datamod, n_batches)
    return latent_scatter(path, {"posterior_mean": z_post, "flow_samples": z_samp})


# the metrics of JAX's chunked step (train/chunked.make_chunked_trainer)
CHUNKED_METRICS = ("flow_loss", "nll_loss", "nlogdet_loss")


def train(config, dirs, device=None, max_steps=None):
    """Train the flow as ``SecondStageExperiment.train`` does, on the
    batches of ``StaticDataModule(config["data"]).loader("train")`` in JAX's
    order (a fresh loader per epoch, at most ``max_batches_per_epoch``
    batches of it), validated on JAX's schedule: every ``val_every_steps
    = max_batches_per_epoch * training.val_every`` steps and at each epoch's
    end (``experiments/base.fit``).  Each validation appends its metrics to
    ``<log dir>/metrics.jsonl`` and keeps the top ``logging.n_saved_ckpt``
    checkpoints by ``FVD-val`` and ``last.npz`` in JAX's layout
    (``CheckpointManager``); every 50 steps, as JAX's, the
    step's metrics go there with the prefix ``train/``.  ``last.npz`` is
    written at the end too when the last step was not validated, and on
    SIGTERM/SIGINT after the step in flight, with ``preempted: True``.

    A fresh run trains in a new version directory.  With
    ``general.restart`` (``--resume``) it trains on in the newest version
    that holds a checkpoint, from the full train state of its ``last.npz``
    (a JAX or a port one): the step counter goes on from the saved step,
    while the epochs and the key start again, as JAX's do.

    Params from ``init_params``; ``make_optimizer`` from the ``training``
    section; ``min_acc_batch_size`` sets the microbatches; the key of step i
    is ``rng, sub = split(rng)`` from ``prng_key(seed)``.  With
    ``training.chunked``, JAX's per-level trainer's semantics on the port's
    one-graph step: only ``flow`` trains (every other key frozen), with
    ``make_optimizer(lr, weight_decay, warmup, total)`` (no clip, adabelief,
    adamw or amsgrad), one microbatch, JAX's three step metrics, and a
    ``ChunkedTrainState`` checkpoint.  ``max_steps`` stops after that many
    steps of this run.

    Returns a dict: ``state``, ``frozen``, ``spec``, ``ckpt`` (the path of
    last.npz), ``ckpt_dir``, ``init_s``, ``save_s``, ``start_step``,
    ``resume`` (``load_s``/``restore_s`` of a resume), ``preempted`` (the
    step of a save on a signal, else None), ``history`` (per step: its
    metrics as floats and ``step_s``, host seconds to a synchronised device)
    and ``val`` (per validation: ``step``, its metrics, ``val_s`` and
    ``save_s``).
    """
    device = resolve_device(device)
    cfg_t = config.setdefault("training", {})
    debug_shrink(config)
    spec = build_spec_from_config(config)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = init_params(config, spec, device)
    sync()
    init_s = time.perf_counter() - t0
    trainable, frozen = train_ss.split_params(params)
    del params
    steps_per_epoch = int(cfg_t.get("max_batches_per_epoch", 2000))
    n_epochs = int(cfg_t.get("n_epochs", 100))
    opt_kw = dict(lr=float(cfg_t.get("lr", 1e-3)),
                  weight_decay=float(cfg_t.get("weight_decay", 1e-5)),
                  warmup_steps=int(cfg_t.get("lr_scaling_max_it", 500)),
                  total_steps=n_epochs * steps_per_epoch)
    chunked = bool(cfg_t.get("chunked"))
    if chunked:
        if spec.augment_channels or spec.use_flow_as_poke:
            raise ValueError("training.chunked: JAX's chunked trainer embeds batch['poke'] and "
                             "has no augment channels")
        frozen.update({k: v for k, v in trainable.items() if k != "flow"})
        trainable = {"flow": trainable["flow"]}
        opt = train_ss.make_optimizer(**opt_kw)
        n_micro = 1
    else:
        opt = train_ss.make_optimizer(
            **opt_kw, clip_grad_norm=float(cfg_t.get("clip_grad_norm", 0.0)),
            use_adabelief=bool(cfg_t.get("use_adabelief", cfg_t.get("adabelief", False))),
            use_adamw=bool(cfg_t.get("use_adamw", False)), amsgrad=bool(cfg_t.get("amsgrad", False)))
        batch_size = int(config["data"].get("batch_size", 8))
        min_acc = int(cfg_t.get("min_acc_batch_size", 0))
        n_micro = max(1, -(-min_acc // batch_size)) if min_acc > batch_size else 1
    step_fn = train_ss.make_train_step(
        spec, frozen, opt, spatial_mean=bool(cfg_t.get("spatial_mean", False)),
        logdet_weight=float(cfg_t.get("logdet_weight", 1.0)), n_microbatches=n_micro)
    datamod = StaticDataModule(config["data"], datakeys=DATAKEYS)
    ckpt_dir = base.run_dir(config, dirs)
    mgr = io.CheckpointManager(ckpt_dir, monitor=MONITOR,
                               top_k=int(config.get("logging", {}).get("n_saved_ckpt", 5)))
    run_log = base.run_logger(dirs)
    state = train_ss.init_state(trainable, opt)
    del trainable   # the init's tensors go once a resume replaces them
    resume = {}
    state = base.maybe_resume(
        config, ckpt_dir, state,
        lambda tree: restore_train_state(tree, opt, state, spec, device), timings=resume)
    run = {"state": state, "rng": prng.prng_key(_seed(config)), "preempted": None}
    del state
    history, vals = [], []

    def step(batch):
        run["rng"], sub = prng.split(run["rng"])
        sync()
        t0 = time.perf_counter()
        run["state"], metrics = step_fn(run["state"], batch, sub)
        sync()
        metrics = {k: float(v) for k, v in metrics.items()
                   if not chunked or k in CHUNKED_METRICS}
        history.append(dict(metrics, step_s=time.perf_counter() - t0))
        log.info("step %d: %s", run["state"].step, " ".join(
            f"{k}={v:.4f}" for k, v in list(history[-1].items())[:4]))
        return metrics

    def run_validation(step_i):
        t0 = time.perf_counter()
        metrics = validate({**frozen, **run["state"].params}, spec, config, datamod,
                           log_dir=dirs.get("log"))
        val_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if MONITOR in metrics:
            mgr.save_step(ckpt_tree(run["state"], opt, spec), step_i, metrics[MONITOR])
        vals.append(dict(metrics, step=step_i, val_s=val_s, save_s=time.perf_counter() - t0))
        log.info("step %d: %s", step_i, " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))
        return metrics

    start_step = run["state"].step
    n_steps = fit(step, n_epochs, train_loader(datamod, device, BATCH_KEYS), steps_per_epoch,
                  validate=run_validation,
                  val_every_steps=int(steps_per_epoch * float(cfg_t.get("val_every", 1.0))),
                  max_steps=max_steps, start_step=start_step, run_log=run_log,
                  save_preempted=base.preempt_saver(
                      ckpt_dir, lambda: ckpt_tree(run["state"], opt, spec), run))
    state = run["state"]
    ckpt = os.path.join(ckpt_dir, "last.npz")
    t0 = time.perf_counter()
    if run["preempted"] is None and (not vals or vals[-1]["step"] != n_steps):
        io.save(ckpt, ckpt_tree(state, opt, spec), metadata={"step": state.step})
    return {"state": state, "frozen": frozen, "spec": spec, "ckpt": ckpt, "ckpt_dir": ckpt_dir,
            "init_s": init_s, "save_s": time.perf_counter() - t0, "start_step": start_step,
            "resume": resume, "preempted": run["preempted"], "history": history, "val": vals}


def test(config, dirs, mode=None, device=None, timings=None):
    """The test mode ``mode`` (default: the config's ``general.test``, else
    ``samples``) of ``eval/test_modes`` on the run's best checkpoint over
    the init (``load_for_serving``), on the test split of the config's data."""
    mode = mode or config["general"].get("test") or "samples"
    fn = test_modes.mode_fn(mode)
    params, spec = load_for_serving(config, dirs, device)
    return fn(params, spec, config, StaticDataModule(config["data"], datakeys=DATAKEYS), dirs,
              timings=timings)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.experiments.second_stage")
    ap.add_argument("command", choices=["train", "test"])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--mode", default="samples", choices=list(test_modes.MODES),
                    help="test mode (test only)")
    ap.add_argument("--base_dir", default=None,
                    help="run tree root (default: the config's general.base_dir, else logs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from ipoke_tpu_torch.config import load_parameters

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    if args.command == "test":
        cfg, dirs = load_parameters(args.config, args.model, base_dir=args.base_dir,
                                    test_mode=args.mode)
        print(json.dumps(test(cfg, dirs, mode=args.mode, device=device), default=float), flush=True)
        return
    cfg, dirs = load_parameters(args.config, args.model, base_dir=args.base_dir)
    run = train(cfg, dirs, device=device, max_steps=args.max_steps)
    last = run["history"][-1] if run["history"] else {}
    print(f"trained {run['state'].step} steps on {device}; last flow_loss "
          f"{last.get('flow_loss', float('nan')):.4f}; {len(run['val'])} validations; "
          f"checkpoints in {run['ckpt_dir']}", flush=True)


if __name__ == "__main__":
    main()
