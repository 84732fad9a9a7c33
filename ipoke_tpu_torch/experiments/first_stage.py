"""Stage-1 runs from a config: the cVAE-GAN trainer (the port's counterpart
of ``ipoke_tpu/experiments/first_stage.py``).

``specs_from_config`` reads the generator and both discriminator specs as
the JAX experiment does; ``train`` trains the three nets on the synthetic
dataset and saves ``last.npz`` in JAX's npz layout.  Validation by FVD,
SSIM, PSNR and LPIPS waits for the metrics (ROADMAP queue 1 item 5), and
the ``poke_vae`` baseline for ``models/variants`` (queue 1 item 8).

    python -m ipoke_tpu_torch.experiments.first_stage train -c <cfg> -m <name> \
        [--max-steps N] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import unbridge_gan_params
from ipoke_tpu_torch.data.synthetic import from_data_config, train_batches
from ipoke_tpu_torch.experiments.second_stage import new_version_dir
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
    optimizer's state under the port's keys (moments in the layout of the
    net without ``u``)."""
    tree = {"step": np.asarray(state.step, np.int32)}
    tree.update(unbridge_gan_params({f"{n}_params": getattr(state, f"{n}_params")
                                     for n in train_fs.NETS}))
    for n in train_fs.NETS:
        trainable = train_fs.trainable(getattr(state, f"{n}_params"))
        opt = optimizers[n].state_tree(getattr(state, f"{n}_opt"), trainable)
        tree[f"{n}_opt"] = {
            name: {k: (unbridge_gan_params({f"{n}_params": v})[f"{n}_params"]
                       if isinstance(v, dict) else np.asarray(v)) for k, v in s.items()}
            for name, s in opt.items()}
    return tree


def train(config, dirs, device=None, max_steps=None):
    """Train the generator and both discriminators as
    ``FirstStageExperiment.train`` does, on the synthetic dataset, and save
    ``last.npz`` in JAX's layout at the end.

    The state from ``init_gan_state(prng_key(seed))``; the optimizers and
    loss weights from the ``training`` section; the key of step i is
    ``rng, sub = split(rng)``.  ``max_steps`` stops early.  Returns a dict:
    ``state``, ``specs``, ``ckpt`` (the path of last.npz), ``init_s``,
    ``save_s`` and ``history`` (per step: its metrics as floats and
    ``step_s``, host seconds to a synchronised device).
    """
    device = resolve_device(device)
    if config.get("architecture", {}).get("baseline", "spade") != "spade":
        raise NotImplementedError("the poke_vae baseline waits for models/variants "
                                  "(ROADMAP queue 1 item 8)")
    cfg_t = config.setdefault("training", {})
    if config["general"].get("debug"):   # the JAX experiment's debug shrink
        cfg_t["max_batches_per_epoch"] = 10
    fs_spec, ds_spec, dt_spec, n_spatial = specs_from_config(config)
    seed = int(config["general"].get("seed", 42))
    steps_per_epoch = int(cfg_t.get("max_batches_per_epoch", 2000))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    state, opts = train_fs.init_gan_state(
        prng.prng_key(seed), fs_spec, ds_spec, dt_spec, lr=float(cfg_t.get("lr", 2e-4)),
        weight_decay=float(cfg_t.get("weight_decay", 1e-5)), gamma=float(cfg_t.get("gamma", 0.98)),
        steps_per_epoch=steps_per_epoch, device=device)
    sync()
    init_s = time.perf_counter() - t0
    step_fn = train_fs.make_gan_train_step(
        fs_spec, ds_spec, dt_spec, opts, w_vgg=float(cfg_t.get("w_vgg", 10.0)),
        w_l1=float(cfg_t.get("w_l1", 10.0)), w_kl=float(cfg_t.get("w_kl", 1e-7)),
        n_spatial_examples=n_spatial, remat=bool(cfg_t.get("remat", False)))
    log.info("validation (FVD, SSIM, PSNR, LPIPS) waits for the metrics port (ROADMAP queue 1 "
             "item 5): this run saves last.npz only")
    data_cfg = config["data"]
    batches = train_batches(from_data_config(data_cfg), int(data_cfg.get("batch_size", 8)),
                            seed=int(data_cfg.get("seed", 0)))
    rng = prng.prng_key(seed)
    total = int(cfg_t.get("n_epochs", 100)) * steps_per_epoch
    total = total if max_steps is None else min(max_steps, total)
    history = []
    for _ in range(total):
        batch = {"images": torch.from_numpy(next(batches)["images"]).to(device)}
        rng, sub = prng.split(rng)
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, sub)
        sync()
        history.append(dict({k: float(v) for k, v in metrics.items()},
                            step_s=time.perf_counter() - t0))
        log.info("step %d: %s", state.step, " ".join(
            f"{k}={history[-1][k]:.4f}" for k in ("loss", "loss_d_dt", "loss_d_ds", "l_rec")))
    ckpt = os.path.join(new_version_dir(dirs["ckpt"]), "last.npz")
    t0 = time.perf_counter()
    io.save(ckpt, ckpt_tree(state, opts), metadata={"step": state.step})
    return {"state": state, "specs": (fs_spec, ds_spec, dt_spec), "ckpt": ckpt,
            "init_s": init_s, "save_s": time.perf_counter() - t0, "history": history}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.experiments.first_stage")
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
    print(f"trained {run['state'].step} steps on {device}; last loss "
          f"{last.get('loss', float('nan')):.4f}; saved {run['ckpt']}", flush=True)


if __name__ == "__main__":
    main()
