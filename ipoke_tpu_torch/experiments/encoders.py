"""Image-encoder and poke-encoder runs from a config (the port's counterpart
of ``ipoke_tpu/experiments/encoders.py``; ``general.experiment:
img_encoder`` or ``poke_encoder``).

``train`` trains the image AE (the stage-2 conditioner) or the poke AE (the
poke embedder) on the config's data through ``StaticDataModule`` in JAX's
order, validated at each epoch's end by ``lpips-val`` (LPIPS of the
reconstructions; for the poke AE of the flow maps, their two channels padded
with a zero third), with the top ``logging.n_saved_ckpt`` checkpoints and
``last.npz`` in JAX's ``AETrainState`` / ``PokeAEState`` npz layout.
``test`` validates the run's best checkpoint.

    python -m ipoke_tpu_torch.experiments.encoders {train,test} -c <cfg> -m <name> \
        [--max-steps N] [--base_dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.data.datamodule import StaticDataModule
from ipoke_tpu_torch.data.loader import to_device
from ipoke_tpu_torch.ckpt.optax_layout import conform
from ipoke_tpu_torch.experiments import base
from ipoke_tpu_torch.experiments.base import debug_shrink, fit, train_loader, version_dir
from ipoke_tpu_torch.metrics.lpips import lpips
from ipoke_tpu_torch.models import encoders
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.train import encoders as train_enc
from ipoke_tpu_torch.utils import prng

log = logging.getLogger(__name__)

MONITOR = "lpips-val"
KINDS = ("img_encoder", "poke_encoder")
# the experiments' datakeys, and the batch keys a step reads
DATAKEYS = {"img_encoder": ("images", "sample_ids"),
            "poke_encoder": ("poke", "flow", "images", "original_flow", "sample_ids")}
BATCH_KEYS = {"img_encoder": ("images",), "poke_encoder": ("poke", "flow", "images")}


def kind_of(config):
    kind = config["general"]["experiment"]
    if kind not in KINDS:
        raise ValueError(f"general.experiment {kind!r} is not one of {KINDS}")
    return kind


def wrapper_spec(config, nf_in, deterministic):
    arch, data = config["architecture"], config["data"]
    ss = data["spatial_size"]
    return WrapperSpec(
        nf_in=nf_in, nf_max=int(arch.get("nf_max", 64)),
        spatial_size=int(ss[0] if isinstance(ss, (tuple, list)) else ss),
        min_spatial_size=int(arch.get("min_spatial_size", 8)), deterministic=deterministic,
        poke_and_image=bool(arch.get("poke_and_image", False)))


def specs_from_config(config):
    """The image AE's (WrapperSpec, PatchDiscSpec), or the poke AE's
    (WrapperSpec, None), as the JAX experiments read them."""
    if kind_of(config) == "img_encoder":
        det = bool(config["architecture"].get("deterministic", False))
        return (wrapper_spec(config, 3, det),
                PatchDiscSpec(gp_weight=float(config.get("training", {}).get("gp_weight", 0.0))))
    return wrapper_spec(config, 2, True), None


@torch.no_grad()
def validate(params, spec, config, datamod):
    """``lpips-val`` over the first ``training.max_val_batches`` batches of
    the val split, as the JAX experiments' ``validate``: the image AE's
    reconstruction of each last frame (the encoder's mean when variational),
    or the poke AE's flow against the batch's flow."""
    device = params["logvar"].device
    kind = kind_of(config)
    flow_ae = bool(config["architecture"].get("flow_ae", False))
    sn = encoders.materialize_spectral_norm(params["model"])
    vals = []
    for bi, raw in enumerate(datamod.loader("val")):
        if bi >= int(config["training"].get("max_val_batches", 50)):
            break
        batch = to_device(raw, device, BATCH_KEYS[kind])
        if kind == "img_encoder":
            x = batch["images"][:, -1]
            enc_spec = spec.encoder_spec
            out, mean, _ = encoders.conv_encoder_apply(sn["encoder"], x, enc_spec)
            rec = encoders.conv_decoder_apply(
                sn["decoder"], [mean if enc_spec.variational else out], spec.decoder_spec)
            vals.append(float(torch.mean(lpips(rec, x))))
        else:
            poke = batch["flow" if flow_ae else "poke"]
            rec = encoders.wrapper_apply(sn, poke, spec)
            zeros = torch.zeros(tuple(batch["flow"].shape[:-1]) + (1,), device=device)
            vals.append(float(torch.mean(lpips(torch.cat([rec, zeros], -1),
                                               torch.cat([batch["flow"], zeros], -1)))))
    return {MONITOR: float(np.mean(vals)) if vals else float("nan")}


def _init(config, spec, disc_spec, device):
    lr = float(config.get("training", {}).get("lr", 1e-4))
    key = prng.prng_key(int(config["general"].get("seed", 42)))
    if disc_spec is not None:
        return train_enc.init_image_ae(key, spec, disc_spec, lr=lr, device=device)
    return train_enc.init_poke_ae(key, spec, lr=lr, device=device)


def ckpt_tree(state):
    return (train_enc.image_ae_ckpt_tree(state) if isinstance(state, train_enc.AETrainState)
            else train_enc.poke_ae_ckpt_tree(state))


def restore_state(tree, template, device=None):
    """``ckpt_tree``'s inverse (``train/encoders.restore_*``) for a JAX or a
    port ``last.npz``; its nets must have ``template``'s keys and shapes
    (KeyError, ValueError).  The restored trees keep the npz's key order,
    which their optimizer state follows."""
    if isinstance(template, train_enc.AETrainState):
        state = train_enc.restore_image_ae(tree, device)
        conform(template.disc_params, state.disc_params)
    else:
        state = train_enc.restore_poke_ae(tree, device)
    conform(template.params, state.params)
    return state


def train(config, dirs, device=None, max_steps=None):
    """Train as ``ImageEncoderExperiment.train`` / ``PokeEncoderExperiment.
    train`` do: the state from ``prng_key(seed)``, step i's key ``rng, sub
    = split(rng)``, ``max_batches_per_epoch`` batches of a fresh
    ``loader("train")`` per epoch, a validation at each epoch's end that
    keeps the top-k checkpoints and ``last.npz`` and logs its metrics to
    ``<log dir>/metrics.jsonl``; ``last.npz`` is written at the end too when
    the last step was not validated.  The run log, the save on
    SIGTERM/SIGINT and ``--resume`` are ``experiments/second_stage.train``'s.
    ``max_steps`` stops after that many steps of this run.

    Returns a dict: ``state``, ``spec``, ``ckpt`` (the path of last.npz),
    ``ckpt_dir``, ``start_step``, ``resume``, ``preempted``, ``history`` (per step: its logs as floats and ``step_s``,
    host seconds to a synchronised device) and ``val`` (per validation:
    ``step``, ``lpips-val``, ``val_s``)."""
    device = resolve_device(device)
    kind = kind_of(config)
    cfg_t = config.setdefault("training", {})
    debug_shrink(config)
    spec, disc_spec = specs_from_config(config)
    state, opts = _init(config, spec, disc_spec, device)
    if disc_spec is not None:
        step_fn = train_enc.make_image_ae_step(spec, disc_spec, opts,
                                               kl_weight=float(cfg_t.get("w_kl", 1e-6)))
    else:
        step_fn = train_enc.make_poke_ae_step(
            spec, opts, flow_ae=bool(config["architecture"].get("flow_ae", False)))
    datamod = StaticDataModule(config["data"], datakeys=DATAKEYS[kind])
    ckpt_dir = base.run_dir(config, dirs)
    mgr = io.CheckpointManager(ckpt_dir, monitor=MONITOR,
                               top_k=int(config.get("logging", {}).get("n_saved_ckpt", 5)))
    run_log = base.run_logger(dirs)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    resume = {}
    state = base.maybe_resume(config, ckpt_dir, state,
                              lambda tree: restore_state(tree, state, device), timings=resume)
    run = {"state": state, "rng": prng.prng_key(int(config["general"].get("seed", 42))),
           "preempted": None}
    del state
    history, vals = [], []

    def step(batch):
        run["rng"], sub = prng.split(run["rng"])
        sync()
        t0 = time.perf_counter()
        run["state"], logs = step_fn(run["state"], batch, sub)
        sync()
        logs = {k: float(v) for k, v in logs.items()}
        history.append(dict(logs, step_s=time.perf_counter() - t0))
        log.info("step %d: %s", run["state"].step, " ".join(
            f"{k}={v:.4f}" for k, v in list(history[-1].items())[:4]))
        return logs

    def run_validation(step_i):
        t0 = time.perf_counter()
        metrics = validate(run["state"].params, spec, config, datamod)
        if MONITOR in metrics:
            mgr.save_step(ckpt_tree(run["state"]), step_i, metrics[MONITOR])
        vals.append(dict(metrics, step=step_i, val_s=time.perf_counter() - t0))
        log.info("step %d: %s=%.6g", step_i, MONITOR, metrics[MONITOR])
        return metrics

    start_step = run["state"].step
    n_steps = fit(step, int(cfg_t.get("n_epochs", 100)),
                  train_loader(datamod, device, BATCH_KEYS[kind]),
                  int(cfg_t.get("max_batches_per_epoch", 2000)), validate=run_validation,
                  max_steps=max_steps, start_step=start_step, run_log=run_log,
                  save_preempted=base.preempt_saver(ckpt_dir, lambda: ckpt_tree(run["state"]),
                                                    run))
    ckpt = os.path.join(ckpt_dir, "last.npz")
    if run["preempted"] is None and (not vals or vals[-1]["step"] != n_steps):
        io.save(ckpt, ckpt_tree(run["state"]), metadata={"step": run["state"].step})
    return {"state": run["state"], "spec": spec, "ckpt": ckpt, "ckpt_dir": ckpt_dir,
            "start_step": start_step, "resume": resume, "preempted": run["preempted"],
            "history": history, "val": vals}


def load_params(config, dirs, device=None):
    """The params of the run's best checkpoint (``find_best``) over the
    init from ``prng_key(seed)``, as the JAX experiments' ``_load``."""
    device = resolve_device(device)
    spec, disc_spec = specs_from_config(config)
    params = _init(config, spec, disc_spec, device)[0].params
    best = io.find_best(version_dir(dirs["ckpt"]))
    if best:
        tree, _ = io.load(best)
        if "params" in tree:
            params = train_enc.bridge_ae_params(tree["params"], device)
            log.info("loaded the params of %s", best)
    else:
        log.warning("no checkpoint under %s: the init from seed %s", dirs["ckpt"],
                    config["general"].get("seed", 42))
    return params, spec


def test(config, dirs, device=None):
    """``validate`` on the run's best params (``load_params``)."""
    params, spec = load_params(config, dirs, device)
    return validate(params, spec, config, StaticDataModule(config["data"],
                                                           datakeys=DATAKEYS[kind_of(config)]))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.experiments.encoders")
    ap.add_argument("command", choices=["train", "test"])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
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
                                    test_mode="samples")
        print(json.dumps(test(cfg, dirs, device=device)), flush=True)
        return
    cfg, dirs = load_parameters(args.config, args.model, base_dir=args.base_dir)
    run = train(cfg, dirs, device=device, max_steps=args.max_steps)
    print(f"trained {run['state'].step} steps on {device}; {len(run['val'])} validations; "
          f"checkpoints in {run['ckpt_dir']}", flush=True)


if __name__ == "__main__":
    main()
