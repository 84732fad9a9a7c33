"""Stage-1 runs from a config: the cVAE-GAN trainer (the port's counterpart
of ``ipoke_tpu/experiments/first_stage.py``).

``specs_from_config`` reads the generator and both discriminator specs as
the JAX experiment does; ``train`` trains the three nets on the config's
data (``data/datamodule.StaticDataModule``), validated at each epoch's end
by FVD, SSIM, PSNR and LPIPS of the reconstructions, and keeps the top-k
checkpoints by ``FVD-val`` and
``last.npz`` in JAX's npz layout; ``test`` validates the best checkpoint.
``architecture.baseline: poke_vae`` trains the PokeVAE cVAE baseline of
``models/variants`` (``stack_motion_and_poke`` read from ``architecture``)
in the generator's place, under the same recipe, as the JAX experiment does.

    python -m ipoke_tpu_torch.experiments.first_stage {train,test} -c <cfg> -m <name> \
        [--max-steps N] [--device cpu]
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
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_gan_params, unbridge_gan_params
from ipoke_tpu_torch.ckpt.optax_layout import conform, from_optax, to_optax
from ipoke_tpu_torch.data.datamodule import StaticDataModule
from ipoke_tpu_torch.eval.test_modes import Clock, params_device
from ipoke_tpu_torch.experiments import base
from ipoke_tpu_torch.experiments.base import MONITOR, debug_shrink, fit, train_loader, version_dir
from ipoke_tpu_torch.metrics.fvd import FVDAccumulator
from ipoke_tpu_torch.metrics.image import psnr, ssim_video
from ipoke_tpu_torch.metrics.lpips import lpips_video
from ipoke_tpu_torch.models import first_stage, variants
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec, TempDiscSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.train import first_stage as train_fs
from ipoke_tpu_torch.utils import prng

log = logging.getLogger(__name__)


def specs_from_config(config):
    """(FirstStageSpec, PatchDiscSpec, TempDiscSpec, n_spatial_examples) of a
    config, as ``FirstStageExperiment.__init__`` reads them; the temporal
    discriminator's ``max_frames`` is clipped to the data's."""
    arch, data, tr = config["architecture"], config["data"], config.get("training", {})
    ss = data["spatial_size"]
    fs = FirstStageSpec(
        z_dim=arch["z_dim"], spatial_size=ss[0] if isinstance(ss, (tuple, list)) else ss,
        max_frames=data["max_frames"], enc_channels=tuple(arch["ENC_M_channels"]),
        dec_channels=tuple(arch["dec_channels"]), n_gru_layers=arch.get("n_gru_layers", 4),
        min_spatial_size=arch.get("min_spatial_size", 8),
        motion_bias=arch.get("motion_bias", False), full_sequence=tr.get("full_sequence", False),
        deterministic=arch.get("deterministic", False), norm=arch.get("norm", "group"),
        spectral_norm=arch.get("spectral_norm", True))
    dt, ds = config.get("d_t", {}), config.get("d_s", {})
    dt_spec = TempDiscSpec(
        spatial_size=fs.spatial_size,
        sequence_length=min(int(dt.get("max_frames", 12)), fs.max_frames),
        patch_temp=bool(dt.get("patch_temp_disc", False)), bce_loss=bool(dt.get("bce_loss", False)),
        gp_weight=float(dt.get("gp_weight", 1.0)), fmap_weight=float(dt.get("fmap_weight", 1.0)),
        gen_weight=float(dt.get("gen_weight", 1.0)))
    ds_spec = PatchDiscSpec(
        bce_loss=bool(ds.get("bce_loss", False)), gp_weight=float(ds.get("gp_weight", 0.0)),
        fmap_weight=float(ds.get("fmap_weight", 1.0)), gen_weight=float(ds.get("gen_weight", 1.0)))
    return fs, ds_spec, dt_spec, int(ds.get("n_examples", 16))


def ckpt_tree(state: train_fs.GanTrainState, optimizers):
    """The train state as JAX's ``_ckpt_tree`` holds a ``GanTrainState``:
    step, the three nets in JAX's layout (``u`` included), and each
    optimizer's state in optax's layout (``ckpt/optax_layout``; ``u`` masked)."""
    tree = {"step": np.asarray(state.step, np.int32)}
    for n in train_fs.NETS:
        key = f"{n}_params"
        export = lambda t, key=key: unbridge_gan_params({key: t})[key]   # noqa: E731
        params = getattr(state, key)
        tree[key] = export(params)
        tree[f"{n}_opt"] = to_optax(optimizers[n], getattr(state, f"{n}_opt"), params, export)
    return tree


def restore_gan_state(tree, optimizers, template: train_fs.GanTrainState, device=None):
    """``ckpt_tree``'s inverse: a ``GanTrainState`` on ``device`` from the
    tree of a JAX or a port ``last.npz``, ``u`` kept and the trainable leaves
    requiring grad; the nets must have ``template``'s keys and shapes
    (KeyError, ValueError)."""
    device = resolve_device(device)
    nets, opts = {}, {}
    for n in train_fs.NETS:
        key = f"{n}_params"
        bridge = lambda t, key=key: bridge_gan_params({key: t}, device)[key]   # noqa: E731
        nets[n] = conform(getattr(template, key), bridge(tree[key]))
        opts[n] = from_optax(optimizers[n], tree[f"{n}_opt"], nets[n], bridge)
        for leaf in train_fs.float_leaves(train_fs.trainable(nets[n])):
            leaf.requires_grad_(True)
    return train_fs.GanTrainState(int(tree["step"]), *(nets[n] for n in train_fs.NETS),
                                  *(opts[n] for n in train_fs.NETS))


def poke_vae_spec(config, fs_spec):
    """The PokeVAESpec of a config with ``architecture.baseline: poke_vae``,
    else None (the SPADE generator), as the JAX experiment picks them."""
    arch = config.get("architecture", {})
    if arch.get("baseline", "spade") != "poke_vae":
        return None
    return variants.PokeVAESpec(first_stage=fs_spec,
                                stack_motion_and_poke=bool(arch.get("stack_motion_and_poke", False)))


def generator_forward(config, fs_spec):
    """``forward(gen_params_sn, batch, rng) -> (x_hat, mu, logvar)`` of the
    config's generator: the PokeVAE's on images and poke, or the first
    stage's on the images."""
    pv_spec = poke_vae_spec(config, fs_spec)
    if pv_spec is not None:
        return lambda p, batch, rng: variants.poke_vae_forward(p, batch, pv_spec, rng=rng)
    return lambda p, batch, rng: first_stage.forward(p, batch["images"], fs_spec, rng=rng)


@torch.no_grad()
def validate(gen_params, fs_spec, config, datamod, timings=None):
    """SSIM, PSNR, LPIPS and FVD of the reconstructions against frames
    1..T-1 over the first ``training.max_val_batches`` batches of the val
    split, as JAX's ``FirstStageExperiment.validate``: the spectral-normed
    generator's ``forward`` on key ``split`` of ``prng_key(7)`` per batch,
    FVD over ``logging.n_samples_fvd`` videos at most; the ``poke_vae``
    baseline's ``poke_vae_forward`` on each batch's images and poke.  Returns
    ``FVD-val``, ``ssim-val``, ``psnr-val`` and ``lpips-val``."""
    device = params_device(gen_params)
    clock = Clock(device, timings)
    acc = FVDAccumulator(n_samples=int(config.get("logging", {}).get("n_samples_fvd", 1000)),
                         device=device)
    ssims, psnrs, lps = [], [], []
    rng = prng.prng_key(7)
    gen_sn = first_stage.materialize_spectral_norm(gen_params)
    forward = generator_forward(config, fs_spec)
    keys = ("images", "poke") if poke_vae_spec(config, fs_spec) else ("images",)
    max_batches = int(config["training"].get("max_val_batches", 100))
    for bi, raw in enumerate(datamod.loader("val")):
        if bi >= max_batches:
            break
        batch = {k: torch.from_numpy(np.asarray(raw[k])).to(device) for k in keys}
        x = batch["images"]
        rng, sub = prng.split(rng)
        t0 = time.perf_counter()
        x_hat, _, _ = forward(gen_sn, batch, sub)
        clock.add("sampling_s", t0)
        t0 = time.perf_counter()
        tgt = x[:, 1:]
        ssims.append(float(ssim_video(x_hat, tgt)))
        psnrs.append(float(psnr(x_hat, tgt)))
        lps.append(float(lpips_video(x_hat, tgt)))
        clock.add("metrics_s", t0)
        acc.update(tgt, x_hat)
    clock.out["i3d_s"] = clock.out.get("i3d_s", 0.0) + acc.feature_s
    out = {"FVD-val": acc.compute() if acc._real else float("nan"),
           "ssim-val": float(np.mean(ssims)), "psnr-val": float(np.mean(psnrs)),
           "lpips-val": float(np.mean(lps))}
    clock.out["frechet_s"] = clock.out.get("frechet_s", 0.0) + acc.frechet_s
    return out


def train(config, dirs, device=None, max_steps=None):
    """Train the generator and both discriminators as
    ``FirstStageExperiment.train`` does, on the batches of
    ``StaticDataModule(config["data"]).loader("train")`` in JAX's order
    (a fresh loader per epoch, at most ``max_batches_per_epoch`` of its
    batches), validated (``validate``) at each epoch's end
    (``experiments/base.fit``; JAX's stage 1 has no step schedule), each
    validation keeping the top
    ``logging.n_saved_ckpt`` checkpoints by ``FVD-val`` and ``last.npz`` in
    JAX's layout and logging its metrics to ``<log dir>/metrics.jsonl``;
    ``last.npz`` is written at the end too when the last step was not
    validated.  The run log, the save on SIGTERM/SIGINT and ``--resume``
    (``general.restart``: the newest version's ``last.npz``, the step
    counter going on from it) are ``experiments/second_stage.train``'s.

    The state from ``init_gan_state(prng_key(seed))``, its generator and
    the generator's optimizer replaced, for the ``poke_vae`` baseline, by
    ``init_poke_vae(prng_key(seed + 1))`` and an optimizer of the same
    settings on it, as in JAX; the optimizers and
    loss weights from the ``training`` section; the key of step i is
    ``rng, sub = split(rng)``.  ``max_steps`` stops after that many steps of
    this run.  Returns a dict: ``state``, ``specs``, ``ckpt`` (the path of
    last.npz), ``ckpt_dir``, ``init_s``, ``save_s``, ``start_step``,
    ``resume``, ``preempted`` (as ``second_stage.train``'s), ``history`` (per step: its metrics as floats and ``step_s``,
    host seconds to a synchronised device) and ``val`` (per validation:
    ``step``, its metrics, ``val_s`` and ``save_s``).
    """
    device = resolve_device(device)
    cfg_t = config.setdefault("training", {})
    debug_shrink(config)
    fs_spec, ds_spec, dt_spec, n_spatial = specs_from_config(config)
    seed = int(config["general"].get("seed", 42))
    steps_per_epoch = int(cfg_t.get("max_batches_per_epoch", 2000))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    opt_kw = dict(lr=float(cfg_t.get("lr", 2e-4)), weight_decay=float(cfg_t.get("weight_decay", 1e-5)),
                  gamma=float(cfg_t.get("gamma", 0.98)), steps_per_epoch=steps_per_epoch)
    state, opts = train_fs.init_gan_state(prng.prng_key(seed), fs_spec, ds_spec, dt_spec,
                                          device=device, **opt_kw)
    pv_spec = poke_vae_spec(config, fs_spec)
    forward_fn = None
    if pv_spec is not None:
        gen = variants.init_poke_vae(prng.prng_key(seed + 1), pv_spec, device)
        for leaf in train_fs.float_leaves(train_fs.trainable(gen)):
            leaf.requires_grad_(True)
        opts["gen"] = train_fs.make_gan_optimizer(**opt_kw)
        state = state._replace(gen_params=gen, gen_opt=opts["gen"].init(train_fs.trainable(gen)))
        forward_fn = generator_forward(config, fs_spec)
    sync()
    init_s = time.perf_counter() - t0
    step_fn = train_fs.make_gan_train_step(
        fs_spec, ds_spec, dt_spec, opts, w_vgg=float(cfg_t.get("w_vgg", 10.0)),
        w_l1=float(cfg_t.get("w_l1", 10.0)), w_kl=float(cfg_t.get("w_kl", 1e-7)),
        n_spatial_examples=n_spatial, remat=bool(cfg_t.get("remat", False)),
        forward_fn=forward_fn)
    datamod = StaticDataModule(config["data"])
    ckpt_dir = base.run_dir(config, dirs)
    mgr = io.CheckpointManager(ckpt_dir, monitor=MONITOR,
                               top_k=int(config.get("logging", {}).get("n_saved_ckpt", 5)))
    run_log = base.run_logger(dirs)
    resume = {}
    state = base.maybe_resume(config, ckpt_dir, state,
                              lambda tree: restore_gan_state(tree, opts, state, device),
                              timings=resume)
    run = {"state": state, "rng": prng.prng_key(seed), "preempted": None}
    del state
    history, vals = [], []

    def step(batch):
        run["rng"], sub = prng.split(run["rng"])
        sync()
        t0 = time.perf_counter()
        run["state"], metrics = step_fn(run["state"], batch, sub)
        sync()
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(dict(metrics, step_s=time.perf_counter() - t0))
        log.info("step %d: %s", run["state"].step, " ".join(
            f"{k}={history[-1][k]:.4f}" for k in ("loss", "loss_d_dt", "loss_d_ds", "l_rec")))
        return metrics

    def run_validation(step_i):
        t0 = time.perf_counter()
        metrics = validate(run["state"].gen_params, fs_spec, config, datamod)
        val_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if MONITOR in metrics:
            mgr.save_step(ckpt_tree(run["state"], opts), step_i, metrics[MONITOR])
        vals.append(dict(metrics, step=step_i, val_s=val_s, save_s=time.perf_counter() - t0))
        log.info("step %d: %s", step_i, " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))
        return metrics

    start_step = run["state"].step
    n_steps = fit(step, int(cfg_t.get("n_epochs", 100)),
                  train_loader(datamod, device, ("images", "poke") if pv_spec else ("images",)),
                  steps_per_epoch,
                  validate=run_validation, max_steps=max_steps, start_step=start_step,
                  run_log=run_log,
                  save_preempted=base.preempt_saver(
                      ckpt_dir, lambda: ckpt_tree(run["state"], opts), run))
    state = run["state"]
    ckpt = os.path.join(ckpt_dir, "last.npz")
    t0 = time.perf_counter()
    if run["preempted"] is None and (not vals or vals[-1]["step"] != n_steps):
        io.save(ckpt, ckpt_tree(state, opts), metadata={"step": state.step})
    return {"state": state, "specs": (fs_spec, ds_spec, dt_spec), "ckpt": ckpt,
            "ckpt_dir": ckpt_dir, "init_s": init_s, "save_s": time.perf_counter() - t0,
            "start_step": start_step, "resume": resume, "preempted": run["preempted"],
            "history": history, "val": vals}


def load_generator(config, dirs, device=None):
    """The generator of the run's best checkpoint (``find_best``), ``u``
    kept; where no checkpoint holds one, the generator of
    ``init_gan_state(prng_key(seed))``, as JAX's ``_load_state``.  For the
    ``poke_vae`` baseline that fallback is the SPADE generator, on which
    JAX's PokeVAE forward then fails for want of ``poke_enc``: the port
    raises that KeyError here."""
    device = resolve_device(device)
    fs_spec = specs_from_config(config)[0]
    best = io.find_best(version_dir(dirs["ckpt"]))
    if best:
        tree, _ = io.load(best)
        if "gen_params" in tree:
            log.info("loaded the generator of %s", best)
            return bridge_gan_params({"gen_params": tree["gen_params"]}, device)["gen_params"]
    if poke_vae_spec(config, fs_spec) is not None:
        raise KeyError("poke_enc: no checkpoint holds a PokeVAE generator, and the fallback of "
                       "JAX's _load_state, init_gan_state's SPADE generator, has no poke_enc")
    log.warning("no checkpoint holds a generator: JAX's init from seed %s",
                config["general"].get("seed", 42))
    key = prng.split(prng.prng_key(int(config["general"].get("seed", 42))), 3)[0]
    return first_stage.init(key, fs_spec, device, spectral_u=True)


def test(config, dirs, device=None, timings=None):
    """``validate`` on the run's best generator (``load_generator``)."""
    gen_params = load_generator(config, dirs, device)
    return validate(gen_params, specs_from_config(config)[0], config,
                    StaticDataModule(config["data"]), timings=timings)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.experiments.first_stage")
    ap.add_argument("command", choices=["train", "test"])
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
    if args.command == "test":
        cfg, dirs = load_parameters(args.config, args.model, test_mode="fvd")
        print(json.dumps(test(cfg, dirs, device=device)), flush=True)
        return
    cfg, dirs = load_parameters(args.config, args.model)
    run = train(cfg, dirs, device=device, max_steps=args.max_steps)
    last = run["history"][-1] if run["history"] else {}
    print(f"trained {run['state'].step} steps on {device}; last loss "
          f"{last.get('loss', float('nan')):.4f}; {len(run['val'])} validations; "
          f"checkpoints in {run['ckpt_dir']}", flush=True)


if __name__ == "__main__":
    main()
