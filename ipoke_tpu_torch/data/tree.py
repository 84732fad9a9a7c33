"""A prepared dataset tree of synthetic videos, in the reference's processed
layout that ``data/datasets.py`` reads (the layout the JAX package's
``data/prepare.py`` writes): per video a directory of frame PNGs and
``prediction_<i>_<i+gap>.flow.npy`` files (CHW float32, one per lag), and a
``meta.p`` pickle at the root.  It stands in for a prepared iPER, Plants,
TaiChi or Human3.6M tree where none is at hand (smoke runs and tests).

    write_tree(root, n_videos=4, n_frames=30, size=256, gaps=(5, 10), train_videos=3)

Each video is two Gaussian blobs moving at constant velocity on a dark
background; the flow of lag g at frame i is the blobs' displacement over g
frames inside their masks.  The meta holds ``img_path``, ``flow_paths``,
``fid``, ``vid``, ``object_id``, ``train`` and ``actor_id``, and with
``keypoints`` also ``keypoints`` and ``nn_ids``; ``train.txt`` names the
first ``train_videos`` videos.  The PNGs are written by ``utils/video.
save_image`` with all five row filters in turn, as an adaptive encoder such
as libpng's mixes them, so a reader undoes Average and Paeth rows too.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ipoke_tpu_torch.utils.video import save_image


def _blobs(rng, size, n_frames, n_blobs=2):
    starts = rng.uniform(size * 0.3, size * 0.7, (n_blobs, 2))
    vel = rng.uniform(-size * 0.01, size * 0.01, (n_blobs, 2))
    colors = rng.uniform(0.5, 2.0, (n_blobs, 3))
    return starts, vel, colors


def _render(centers, colors, size):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    sigma = size / 10
    img = np.full((size, size, 3), -1.0, np.float32)
    for (cy, cx), col in zip(centers, colors):
        g = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2)))
        img += g[..., None] * col[None, None]
    return np.clip(img, -1, 1)


def _flow(centers, vel, gap, size):
    """(2, S, S): the displacement of each blob over ``gap`` frames inside
    its mask, rows then columns."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    sigma = size / 10
    flow = np.zeros((2, size, size), np.float32)
    for (cy, cx), v in zip(centers, vel):
        mask = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))) > 0.3
        flow[0] += mask * v[0] * gap
        flow[1] += mask * v[1] * gap
    return flow


def write_tree(root, n_videos=4, n_frames=30, size=256, gaps=(5, 10), train_videos=3,
               seed=0, keypoints=False):
    """Write the tree under ``root``; returns the path of ``meta.p``."""
    rng = np.random.default_rng(seed)
    meta = {k: [] for k in ("img_path", "flow_paths", "fid", "vid", "object_id", "train",
                            "actor_id")}
    kps = []
    names = [f"person{v}_take{v % 2}" for v in range(n_videos)]
    for v, name in enumerate(names):
        starts, vel, colors = _blobs(rng, size, n_frames)
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i in range(n_frames):
            centers = starts + vel * i
            img = os.path.join(name, f"frame_{i:04d}.png")
            save_image(_render(centers, colors, size), os.path.join(root, img), filters=range(5))
            flows = []
            for g in gaps:
                fp = os.path.join(name, f"prediction_{i}_{i + g}.flow.npy")
                if i + g < n_frames:
                    np.save(os.path.join(root, fp), _flow(centers, vel, g, size))
                flows.append(fp)
            meta["img_path"].append(img)
            meta["flow_paths"].append(flows)
            meta["fid"].append(i)
            meta["vid"].append(v)
            meta["object_id"].append(v)
            meta["train"].append(v < train_videos)
            meta["actor_id"].append(9 if v >= train_videos else 1)
            if keypoints:
                kps.append(rng.uniform(2, 30, (6, 2)).astype(np.float32))
    if keypoints:
        meta["keypoints"] = kps
        n = len(meta["vid"])
        meta["nn_ids"] = [(i + n_frames) % n for i in range(n)]
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("".join(f"{name.replace('_', '/', 1)}\n" for name in names[:train_videos]))
    path = os.path.join(root, "meta.p")
    with open(path, "wb") as f:
        pickle.dump({k: np.asarray(vals) for k, vals in meta.items()}, f)
    return path
