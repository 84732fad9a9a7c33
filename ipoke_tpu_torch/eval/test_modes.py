"""The stage-2 ``test`` modes (counterpart of ``ipoke_tpu/eval/test_modes.py``;
the reference's models/second_stage_video.py:661-1171).

Every mode takes (params, spec, config, datamod, dirs): the model's params
on the device it samples on, its spec, the run's config, a data module with
``loader('test')`` (``data/datamodule.StaticDataModule``) and the run's
directories.  It writes its artifacts under ``dirs['generated']`` in the JAX
package's layout and returns a summary dict, also written to
``generated/metrics/<mode>.json``.  The keys are JAX's:
``prng_key(testing.seed)``, then ``rng, sub = split(rng)`` per batch.

``timings``, a dict a caller may pass, gets the mode's host seconds by part
(``sampling_s``, ``i3d_s``, ``frechet_s``, ``metrics_s``, ``write_s``, each
to a synchronised device).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.train.second_stage import leaves
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.video import enrollment, save_image, save_video

BATCH_KEYS = ("images", "poke", "flow")
# dump the real/fake uint8 videos of run_fvd when they stay under this, unless
# testing.save_fvd_npy says otherwise
NPY_AUTO_BYTES = 200 * 1024 * 1024


def _summary(dirs, mode, payload):
    mdir = os.path.join(dirs["generated"], "metrics")
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, f"{mode}.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    return payload


class Clock:
    """Host seconds by part, each read after the device has finished."""

    def __init__(self, device, out):
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.out = out if out is not None else {}

    def add(self, part, t0):
        self.sync()
        self.out[part] = self.out.get(part, 0.0) + time.perf_counter() - t0


def params_device(params):
    """The device of a param tree (its first leaf's)."""
    return next(iter(leaves(params))).device


def _sampler(params, spec, n_samples):
    def sample(batch, key):
        return second_stage.forward_sample(params, spec, batch, key, n_samples=n_samples)

    return sample


def _to_batch(raw, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in raw.items() if k in BATCH_KEYS}


def run_samples(params, spec, config, datamod, dirs, timings=None):
    """Per-example videos (mp4, or npy without cv2) and enrollment PNGs under
    ``generated/samples_best_fvd/sid_<id>/<timestamp>`` (reference :895-946)."""
    tcfg = config.get("testing", {})
    n_samples = int(tcfg.get("n_samples_per_data_point", 5))
    n_vis = int(tcfg.get("n_samples_vis", 10))
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    device = params_device(params)
    clock = Clock(device, timings)
    sample = _sampler(params, spec, n_samples)
    rng = prng.prng_key(int(tcfg.get("seed", 42)))
    out_root = os.path.join(dirs["generated"], "samples_best_fvd")
    count = 0
    for batch in datamod.loader("test"):
        if count >= n_vis:
            break
        rng, sub = prng.split(rng)
        t0 = time.perf_counter()
        vids = sample(_to_batch(batch, device), sub).float().cpu().numpy()   # (N,B,T,H,W,3)
        clock.add("sampling_s", t0)
        t0 = time.perf_counter()
        sids = np.asarray(batch["sample_ids"])
        for bi in range(vids.shape[1]):
            if count >= n_vis:
                break
            sid_dir = os.path.join(out_root, f"sid_{int(sids[bi])}", stamp)
            save_video(batch["images"][bi], os.path.join(sid_dir, "groundtruth.mp4"))
            for si in range(vids.shape[0]):
                clip = np.concatenate([batch["images"][bi][:1], vids[si, bi]], 0)
                save_video(clip, os.path.join(sid_dir, f"sample_{si}.mp4"))
                save_image(enrollment(clip), os.path.join(sid_dir, f"enrollment_{si}.png"))
            count += 1
        clock.add("write_s", t0)
    return _summary(dirs, "samples", {"n_examples": count, "dir": out_root})


def run_fvd(params, spec, config, datamod, dirs, timings=None):
    """FVD of one sample per test example against the example's frames 1..T-1
    (reference :665-678, 1064-1090), wrapping over the split until
    ``testing.n_samples_fvd`` videos.  Features are kept, not videos
    (``FVDAccumulator``).  The real/fake uint8 tensors are written to
    ``generated/samples_fvd/*.npy`` when ``testing.save_fvd_npy`` is set, or,
    unset, when both stay under 200 MB.  The score's key is ``FVD`` only with
    pretrained I3D weights, else ``FVD_UNPRETRAINED``."""
    from ipoke_tpu_torch.metrics.fvd import FVDAccumulator

    tcfg = config.get("testing", {})
    n_target = int(tcfg.get("n_samples_fvd", 1000))
    device = params_device(params)
    clock = Clock(device, timings)
    sample = _sampler(params, spec, 1)
    rng = prng.prng_key(int(tcfg.get("seed", 42)))
    acc = FVDAccumulator(n_samples=n_target, device=device)
    frame_shape = None
    reals_u8, fakes_u8 = [], []
    save_npy = tcfg.get("save_fvd_npy")
    n = 0
    while n < n_target:
        advanced = False
        for batch in datamod.loader("test"):
            if n >= n_target:
                break
            rng, sub = prng.split(rng)
            t0 = time.perf_counter()
            fake = sample(_to_batch(batch, device), sub)[0]
            clock.add("sampling_s", t0)
            real = np.asarray(batch["images"][:, 1:])
            acc.update(real, fake)
            if frame_shape is None:
                frame_shape = real.shape[1:]
                if save_npy is None:
                    save_npy = 2 * n_target * int(np.prod(frame_shape)) < NPY_AUTO_BYTES
            if save_npy:
                reals_u8.append(((real + 1) * 127.5).astype(np.uint8))
                fakes_u8.append(((fake.float().cpu().numpy() + 1) * 127.5).astype(np.uint8))
            n += fake.shape[0]
            advanced = True
        if not advanced:
            break
    npy_dir = None
    if save_npy and reals_u8:
        npy_dir = os.path.join(dirs["generated"], "samples_fvd")
        os.makedirs(npy_dir, exist_ok=True)
        np.save(os.path.join(npy_dir, "real_samples.npy"), np.concatenate(reals_u8)[:n_target])
        np.save(os.path.join(npy_dir, "fake_samples.npy"), np.concatenate(fakes_u8)[:n_target])
    score = acc.compute()
    clock.out["i3d_s"] = clock.out.get("i3d_s", 0.0) + acc.feature_s
    clock.out["frechet_s"] = clock.out.get("frechet_s", 0.0) + acc.frechet_s
    key = "FVD" if acc.pretrained else "FVD_UNPRETRAINED"
    payload = {key: score, "n": min(n, n_target), "i3d_pretrained": acc.pretrained}
    if npy_dir:
        payload["npy_dir"] = npy_dir
    else:
        payload["npy_skipped"] = "set testing.save_fvd_npy to dump real/fake npy tensors"
    return _summary(dirs, "fvd", payload)


def run_diversity(params, spec, config, datamod, dirs, timings=None):
    """Pairwise VGG-cosine, MSE and LPIPS diversity over
    ``n_samples_per_data_point`` samples of ``n_samples_metrics`` test
    examples (reference :746-752, 1126-1155)."""
    from ipoke_tpu_torch.metrics.diversity import div_score_lpips, div_score_mse, div_score_vgg

    tcfg = config.get("testing", {})
    n_samples = int(tcfg.get("n_samples_per_data_point", 5))
    n_target = int(tcfg.get("n_samples_metrics", 100))
    device = params_device(params)
    clock = Clock(device, timings)
    sample = _sampler(params, spec, n_samples)
    rng = prng.prng_key(int(tcfg.get("seed", 42)))
    chunks = []
    n = 0
    for batch in datamod.loader("test"):
        if n >= n_target:
            break
        rng, sub = prng.split(rng)
        t0 = time.perf_counter()
        vids = sample(_to_batch(batch, device), sub)      # (N,B,T,H,W,3)
        clock.add("sampling_s", t0)
        chunks.append(vids.float().transpose(0, 1))
        n += vids.shape[1]
    samples = torch.cat(chunks)[:n_target]
    t0 = time.perf_counter()
    payload = {
        "div_vgg_cosine": div_score_vgg(samples),
        "div_mse": div_score_mse(samples),
        "div_lpips": div_score_lpips(samples),
        "n": int(samples.shape[0]),
    }
    clock.add("metrics_s", t0)
    return _summary(dirs, "diversity", payload)


MODES = {"samples": run_samples, "fvd": run_fvd, "diversity": run_diversity}
# the modes still to port, and what each waits for
NOT_PORTED = {
    "accuracy": "metrics/pose.py and the KPS protocol",
    "control_sensitivity": "data/poke.py, utils/vis.py and utils/plots.py",
    "transfer": "data/poke.py, utils/vis.py and utils/plots.py",
    "kps_acc": "metrics/pose.py and the KPS protocol",
}
ALL_MODES = (*MODES, *NOT_PORTED)


def mode_fn(mode):
    """The function of test mode ``mode``; an unported mode raises
    ``NotImplementedError`` naming what it waits for."""
    if mode in NOT_PORTED:
        raise NotImplementedError(
            f"test mode {mode!r} waits for {NOT_PORTED[mode]} (ROADMAP queue 1 item 5)")
    if mode not in MODES:
        raise ValueError(f"unknown test mode {mode!r}; one of {ALL_MODES}")
    return MODES[mode]
