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
(``sampling_s``, ``i3d_s``, ``frechet_s``, ``metrics_s``, ``pose_s``,
``keypoint_mse_s``, ``write_s``, each to a synchronised device).
"""
from __future__ import annotations

import csv
import json
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch.flows import transformer
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


def _iter_examples(datamod, n_target, split="test"):
    """The raw batches of ``split``, looping over it again until
    ``n_target`` examples have been given (a split shorter than that
    wraps, as the reference's test loops do)."""
    n = 0
    while n < n_target:
        advanced = False
        for raw in datamod.loader(split):
            if n >= n_target:
                return
            yield raw
            n += int(np.asarray(raw["sample_ids"]).shape[0] or 1)
            advanced = True
        if not advanced:
            return


def _neg_ssim_frames(a, b):
    from ipoke_tpu_torch.metrics.image import ssim_per_frame

    return -ssim_per_frame(a, b)


def run_accuracy(params, spec, config, datamod, dirs, timings=None):
    """Best-of-N LPIPS and SSIM per frame (reference :681-743) and the
    KPSMetric keypoint protocol (utils/metrics.py:259-331) over
    ``testing.n_samples_metrics`` test examples, ``n_samples_per_data_point``
    samples each: the pose net's keypoints of every sample against those of
    the ground truth (the batch's ``keypoints_rel`` where it has them), the
    sample nearest over the clip chosen per example.  Writes
    ``metrics/accuracy.csv`` (frame, LPIPS, SSIM), then
    ``lpips_per_frame.png`` and ``accuracy_two_axes.png`` (matplotlib, which
    raises where it is missing, after the CSV).  The LPIPS and KPS keys end
    in ``_UNPRETRAINED`` without the VGG16/LPIPS or pose weights.

    With ``testing.summarize_n_pokes``, the mode runs again for each fixed
    poke count 1..``data.n_pokes`` on its own ``StaticDataModule`` and
    returns (and writes as ``accuracy_per_n_pokes``) the LPIPS and SSIM of
    each count."""
    from ipoke_tpu_torch.metrics.lpips import lpips_pretrained

    lp_key = "LPIPS" if lpips_pretrained() else "LPIPS_UNPRETRAINED"
    if config.get("testing", {}).get("summarize_n_pokes"):
        from ipoke_tpu_torch.data.datamodule import StaticDataModule

        per_n = {}
        base_cfg = dict(config["data"])
        cfg2 = {k: v for k, v in config.items() if k != "testing"}
        cfg2["testing"] = {**config["testing"], "summarize_n_pokes": False}
        for n in range(1, int(config["data"].get("n_pokes", 5)) + 1):
            dm = StaticDataModule({**base_cfg, "n_pokes": n, "fix_n_pokes": True})
            res = run_accuracy(params, spec, cfg2, dm, dirs, timings=timings)
            per_n[n] = {lp_key: res[lp_key], "SSIM": res["SSIM"]}
        return _summary(dirs, "accuracy_per_n_pokes", per_n)
    from ipoke_tpu_torch.metrics import pose as pose_mod
    from ipoke_tpu_torch.metrics.image import best_of_n_metric
    from ipoke_tpu_torch.metrics.lpips import lpips as lpips_fn

    tcfg = config.get("testing", {})
    n_samples = int(tcfg.get("n_samples_per_data_point", 5))
    n_target = int(tcfg.get("n_samples_metrics", 1000))
    device = params_device(params)
    clock = Clock(device, timings)
    sample = _sampler(params, spec, n_samples)
    rng = prng.prng_key(int(tcfg.get("seed", 42)))
    lp_means, ss_means = [], []
    kps_nn_frames, kps_nn = [], []
    n = 0
    for raw in datamod.loader("test"):
        if n >= n_target:
            break
        rng, sub = prng.split(rng)
        t0 = time.perf_counter()
        batch = _to_batch(raw, device)
        vids = sample(batch, sub).float()                    # (N,B,T,H,W,3)
        clock.add("sampling_s", t0)
        t0 = time.perf_counter()
        tgt = batch["images"][:, 1:]
        lp_m, _ = best_of_n_metric(lpips_fn, vids, tgt)
        ss_m, _ = best_of_n_metric(_neg_ssim_frames, vids, tgt)
        lp_means.append(lp_m.cpu().numpy())
        ss_means.append(-ss_m.cpu().numpy())
        clock.add("metrics_s", t0)
        t0 = time.perf_counter()
        t = tgt.shape[1]
        if "keypoints_rel" in raw:
            kp_gt = np.asarray(raw["keypoints_rel"], np.float32)[:, None]
            if kp_gt.ndim == 4:   # (B,1,K,2): static keypoints, the same in every frame
                kp_gt = np.repeat(kp_gt[:, :, None], t, axis=2)
        else:
            kp_gt = pose_mod.video_keypoints_rel(tgt)[:, None]
        kp_pred = np.stack([pose_mod.video_keypoints_rel(v) for v in vids], axis=1)   # (B,N,T,K,2)
        stats = pose_mod.kps_nn_protocol(kp_pred, kp_gt)
        kps_nn_frames.append(stats["nn_err_per_frame"])
        kps_nn.append(stats["nn_err"])
        clock.add("pose_s", t0)
        n += tgt.shape[0]
    t0 = time.perf_counter()
    lp = np.mean(np.stack(lp_means), 0)
    ss = np.mean(np.stack(ss_means), 0)
    kps_key = "KPS" if pose_mod.pose_weights_available() else "KPS_UNPRETRAINED"
    kps_pf = np.concatenate(kps_nn_frames).mean(0)
    payload = {
        f"{lp_key}_per_frame": lp.tolist(), "SSIM_per_frame": ss.tolist(),
        lp_key: float(lp.mean()), "SSIM": float(ss.mean()), "n": n,
        kps_key: float(np.concatenate(kps_nn).mean()),
        f"{kps_key}_per_frame": kps_pf.tolist(),
    }
    mdir = os.path.join(dirs["generated"], "metrics")
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, "accuracy.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "LPIPS", "SSIM"])
        for i, (a, b) in enumerate(zip(lp, ss)):
            w.writerow([i, float(a), float(b)])
    from ipoke_tpu_torch.utils.plots import errorbar_plot, two_axes_plot

    lp_std = np.std(np.stack(lp_means), 0)
    errorbar_plot(os.path.join(mdir, "lpips_per_frame.png"), lp, lp_std, ylabel="LPIPS")
    two_axes_plot(os.path.join(mdir, "accuracy_two_axes.png"), np.arange(len(lp)), lp, ss)
    clock.add("write_s", t0)
    return _summary(dirs, "accuracy", payload)


def run_control_sensitivity(params, spec, config, datamod, dirs, timings=None):
    """How the motion follows the poke's direction (reference :786-891):
    per test batch, the poke moved to the most poked pixel of each example,
    at the ground truth's largest magnitude, in ``n_control_sensitivity_pokes``
    random directions (``np.random.default_rng(0)``), one sample each; the
    response is the mean |frame - first frame| in the 16x16 region around
    the poke, per direction, and ``response_cv_across_directions`` the mean
    over batches of the std across directions of each example's response
    over the mean response.

    Artefacts for the first ``n_samples_vis`` examples, under
    ``poke_dir_samples_best_fvd/sid_<id>/<stamp>/``: overview (labelled grid),
    samples_all (unlabelled), groundtruth and sample_<i> videos, each with
    ``<name>_enrollment.png``; sample 1 answers the original poke (one more
    sampling call while examples are still saved), 2..K+1 the directions.
    Writes ``metrics/control_sensitivity.csv``."""
    from ipoke_tpu_torch.data.poke import poke_from_coords
    from ipoke_tpu_torch.utils.vis import make_multipoke_grid

    tcfg = config.get("testing", {})
    k = int(tcfg.get("n_control_sensitivity_pokes", 8))
    n_target = int(tcfg.get("n_samples_metrics", 100))
    n_vis = int(tcfg.get("n_samples_vis", 4))
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    out_root = os.path.join(dirs["generated"], "poke_dir_samples_best_fvd")
    device = params_device(params)
    clock = Clock(device, timings)
    sample = _sampler(params, spec, 1)
    rng = prng.prng_key(int(tcfg.get("seed", 42)))
    angle_rng = np.random.default_rng(0)
    per_direction = [[] for _ in range(k)]
    dir_alignment = []
    n = 0
    saved = 0

    def sample_np(batch, key):
        t0 = time.perf_counter()
        out = sample(batch, key)[0].float().cpu().numpy()
        clock.add("sampling_s", t0)
        return out

    for raw in _iter_examples(datamod, n_target):
        batch = _to_batch(raw, device)
        poke = np.asarray(raw["poke"], np.float32)
        imgs = np.asarray(raw["images"], np.float32)
        b, h, w, _ = poke.shape
        mags = np.abs(poke).sum(-1).reshape(b, -1)
        centers = np.stack(np.unravel_index(mags.argmax(1), (h, w)), -1)
        base_mag = np.linalg.norm(poke.reshape(b, -1, 2), axis=-1).max(1)
        region = np.zeros((b, h, w, 1), np.float32)   # the 16x16 square around each centre
        for i, (r, c) in enumerate(centers):
            region[i, max(r - 8, 0): r + 8, max(c - 8, 0): c + 8] = 1.0
        responses = []
        vis_pokes, vis_vids = [], []   # leading axis: 1 + k pokes
        if saved < n_vis:
            rng, sub = prng.split(rng)
            vis_pokes.append(poke)
            vis_vids.append(sample_np(batch, sub))
        for ki in range(k):
            theta = angle_rng.uniform(0, 2 * np.pi, b)
            disp = np.stack([np.sin(theta), np.cos(theta)], -1) * base_mag[:, None]
            pokes = np.stack([poke_from_coords((h, w), centers[i: i + 1], disp[i: i + 1])
                              for i in range(b)])
            rng, sub = prng.split(rng)
            vids = sample_np({**batch, "poke": torch.from_numpy(pokes).to(device)}, sub)
            resp = np.abs(vids - imgs[:, :1]).mean(-1, keepdims=True)
            per_direction[ki].append(float((resp.mean(1) * region).sum() / region.sum() / b))
            responses.append(resp.mean((1, 2, 3, 4)))
            if saved < n_vis:
                vis_pokes.append(pokes)
                vis_vids.append(vids)
        resp_arr = np.stack(responses)   # (k, b)
        dir_alignment.append(float(resp_arr.std(0).mean() / (resp_arr.mean() + 1e-8)))
        t0 = time.perf_counter()
        if vis_vids:
            sids = np.asarray(raw["sample_ids"]).reshape(-1)
            for bi in range(b):
                if saved >= n_vis:
                    break
                ex_pokes = np.stack([p[bi] for p in vis_pokes])      # (k+1,H,W,2)
                ex_vids = np.stack([v[bi] for v in vis_vids])        # (k+1,T,H,W,3)
                rows, grid, grid_unl = make_multipoke_grid(imgs[bi, 0], ex_pokes, imgs[bi, 1:], ex_vids)
                sdir = os.path.join(out_root, f"sid_{int(sids[bi])}", stamp)
                save_video(grid, os.path.join(sdir, "overview.mp4"))
                save_video(grid_unl, os.path.join(sdir, "samples_all.mp4"))
                for i, row in enumerate(rows):
                    name = "groundtruth" if i == 0 else f"sample_{i}"
                    save_video(row, os.path.join(sdir, f"{name}.mp4"))
                    save_image(enrollment(row), os.path.join(sdir, f"{name}_enrollment.png"))
                saved += 1
        clock.add("write_s", t0)
        n += b
    per_dir_mean = [float(np.mean(r)) for r in per_direction if r]
    payload = {
        "per_direction_response": per_dir_mean,
        "mean_response": float(np.mean(per_dir_mean)),
        "response_cv_across_directions": float(np.mean(dir_alignment)),
        "n_examples": n,
        "n_directions": k,
        "artifact_dir": out_root,
        "n_artifact_examples": saved,
    }
    mdir = os.path.join(dirs["generated"], "metrics")
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, "control_sensitivity.csv"), "w", newline="") as f:
        wtr = csv.writer(f)
        wtr.writerow(["direction", "response"])
        for i, v in enumerate(per_dir_mean):
            wtr.writerow([i, v])
    return _summary(dirs, "control_sensitivity", payload)


@torch.no_grad()
def transfer_batch(params, spec, batch, x_b, poke_b):
    """Sequence A's motion under B's conditioning (reference :948-1034):
    A's motion latent gaussianised by ``transformer.forward`` under A's
    conditioning, then ``reverse`` under B's (K2 on the card), the augment
    channels cut, decoded from B's first frame.  Returns (videos (B, T-1,
    H, W, 3), A's per-frame motion energy, the transfer's), the energies
    the mean |frame - first frame| of each frame, (B, T-1)."""
    x = batch["images"]
    cond_a = second_stage.embed_cond(params, spec, x[:, 0], batch["poke"])
    motion_a, _ = second_stage.encode_first_stage(params, spec, x)
    residual = transformer.forward(params["flow"], spec.flow, motion_a, cond_a)[0]
    cond_b = second_stage.embed_cond(params, spec, x_b[:, 0], poke_b)
    motion_t = transformer.reverse(params["flow"], spec.flow, residual, cond_b)
    if spec.augment_channels:
        motion_t = motion_t[..., :-spec.augment_channels]
    vids = second_stage.decode_first_stage(params, spec, motion_t, x_b[:, 0], x.shape[1] - 1)
    src_energy = (x[:, 1:] - x[:, :1]).abs().mean(dim=(2, 3, 4))
    tr_energy = (vids - x_b[:, :1]).abs().mean(dim=(2, 3, 4))
    return vids, src_energy, tr_energy


def run_transfer(params, spec, config, datamod, dirs, timings=None):
    """Motion transfer over ``testing.n_samples_metrics`` test examples
    (``transfer_batch``): B is the dataset's nearest-neighbour partner
    (``nn_images``/``nn_poke``) where the batch has one, else the batch
    rolled by one.  ``motion_energy_correlation`` is the mean over batches
    of the correlation of A's and the transfer's per-frame motion energy
    (batches where either is constant left out).  Writes ``transfer_<i>``,
    ``source_<i>`` and ``target_<i>`` videos of the first ``n_samples_vis``
    examples under ``transfer/<stamp>/``."""
    tcfg = config.get("testing", {})
    n_target = int(tcfg.get("n_samples_metrics", 100))
    n_vis = int(tcfg.get("n_samples_vis", 4))
    tdir = os.path.join(dirs["generated"], "transfer", time.strftime("%Y-%m-%d_%H-%M-%S"))
    device = params_device(params)
    clock = Clock(device, timings)
    n = 0
    saved = 0
    corr = []
    for raw in _iter_examples(datamod, n_target):
        batch = _to_batch(raw, device)
        x = batch["images"]
        if "nn_images" in raw:
            x_b = torch.from_numpy(np.asarray(raw["nn_images"])).to(device)
            poke_b = torch.from_numpy(np.asarray(raw["nn_poke"])).to(device)
        else:
            x_b = torch.roll(x, 1, dims=0)
            poke_b = torch.roll(batch["poke"], 1, dims=0)
        t0 = time.perf_counter()
        vids, src_e, tr_e = transfer_batch(params, spec, batch, x_b, poke_b)
        clock.add("sampling_s", t0)
        t0 = time.perf_counter()
        a = src_e.float().cpu().numpy().reshape(-1)
        bb = tr_e.float().cpu().numpy().reshape(-1)
        if a.std() > 1e-8 and bb.std() > 1e-8:
            corr.append(float(np.corrcoef(a, bb)[0, 1]))
        for i in range(vids.shape[0]):
            if saved >= n_vis:
                break
            save_video(vids[i].float().cpu().numpy(), os.path.join(tdir, f"transfer_{saved}.mp4"))
            save_video(x[i].cpu().numpy(), os.path.join(tdir, f"source_{saved}.mp4"))
            save_video(x_b[i].cpu().numpy(), os.path.join(tdir, f"target_{saved}.mp4"))
            saved += 1
        clock.add("write_s", t0)
        n += int(vids.shape[0])
    payload = {
        "n": n,
        "dir": tdir,
        "motion_energy_correlation": float(np.mean(corr)) if corr else None,
    }
    return _summary(dirs, "transfer", payload)


KPS_STATUS = ("pose weights unavailable (no-egress env): keypoint numbers come "
              "from a RANDOM backbone (protocol check only); provide "
              "$IPOKE_WEIGHTS/pose_resnet_152.npz for real keypoint metrics")


def run_kps_acc(params, spec, config, datamod, dirs, timings=None):
    """Keypoint accuracy with keypoint pokes (reference :761-783, through
    PoseNetWrapper and KPSMetric): ``metrics/pose.keypoint_mse``, always run.
    Without the pose weights its numbers come from the seeded backbone: the
    payload then says so in ``status`` and adds a pixel end-point proxy, the
    mean |sample - ground truth| of the last frame and of all frames, one
    sample per example over ``testing.n_samples_metrics`` examples."""
    from ipoke_tpu_torch.metrics.pose import keypoint_mse, pose_weights_available

    tcfg = config.get("testing", {})
    device = params_device(params)
    clock = Clock(device, timings)
    t0 = time.perf_counter()
    payload = dict(keypoint_mse(params, spec, config, datamod))
    clock.add("keypoint_mse_s", t0)
    if not pose_weights_available():
        payload["status"] = KPS_STATUS
        n_target = int(tcfg.get("n_samples_metrics", 100))
        sample = _sampler(params, spec, 1)
        rng = prng.prng_key(int(tcfg.get("seed", 42)))
        errs_last, errs_mean = [], []
        n = 0
        for raw in _iter_examples(datamod, n_target):
            rng, sub = prng.split(rng)
            t0 = time.perf_counter()
            vids = sample(_to_batch(raw, device), sub)[0].float().cpu().numpy()
            clock.add("sampling_s", t0)
            gt = np.asarray(raw["images"], np.float32)[:, 1:]
            errs_last.append(float(np.abs(vids[:, -1] - gt[:, -1]).mean()))
            errs_mean.append(float(np.abs(vids - gt).mean()))
            n += vids.shape[0]
        payload.update({
            "pixel_epe_proxy_last_frame": float(np.mean(errs_last)),
            "pixel_epe_proxy_all_frames": float(np.mean(errs_mean)),
            "n_examples": n,
        })
    return _summary(dirs, "kps_acc", payload)


MODES = {"samples": run_samples, "fvd": run_fvd, "accuracy": run_accuracy,
         "diversity": run_diversity, "control_sensitivity": run_control_sensitivity,
         "transfer": run_transfer, "kps_acc": run_kps_acc}


def mode_fn(mode):
    """The function of test mode ``mode``; an unknown mode raises ``ValueError``."""
    if mode not in MODES:
        raise ValueError(f"unknown test mode {mode!r}; one of {tuple(MODES)}")
    return MODES[mode]
