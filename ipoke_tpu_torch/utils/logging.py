"""A run's record: the console and a JSONL stream of scalars (the port's
counterpart of ``ipoke_tpu/utils/logging.py``).

``RunLogger(log_dir).log_scalars(step, {...}, prefix)`` appends one line
``{"step", "time", "<prefix><key>": float, ...}`` to
``<log_dir>/metrics.jsonl``, as JAX's does; ``log_video`` / ``log_image``
write media files beside it.  wandb is an optional import: where it is
missing the logger warns and keeps the JSONL sink.  ``latent_scatter``
draws the stage-2 validation's scatter of latents with matplotlib, imported
when it is called.
"""
from __future__ import annotations

import json
import logging
import os
import time

import numpy as np


def get_logger(name="ipoke_tpu_torch"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class RunLogger:
    def __init__(self, log_dir, use_wandb=False, project="poking_inn", run_name=None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.metrics_path = os.path.join(log_dir, "metrics.jsonl")
        self.console = logging.getLogger(__name__)
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=project, name=run_name, dir=log_dir)
            except Exception as e:  # noqa: BLE001  (no wandb, or no network)
                self.console.warning(f"wandb unavailable ({e}); using JSONL sink")

    def log_scalars(self, step, scalars: dict, prefix=""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[f"{prefix}{k}"] = float(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v))
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb:
            self.wandb.log({k: v for k, v in rec.items() if k != "time"}, step=int(step))

    def log_video(self, step, name, frames, fps=3):
        """``frames`` (T, H, W, 3) as ``<name>_step<step>.mp4`` (``.npy``
        without cv2, ``utils/video.save_video``); returns the path written."""
        from ipoke_tpu_torch.utils.video import save_video

        path = save_video(frames, os.path.join(self.log_dir, f"{name}_step{int(step)}.mp4"), fps=fps)
        if self.wandb and path.endswith(".mp4"):
            self.wandb.log({name: self.wandb.Video(path, fps=fps, format="mp4")}, step=int(step))
        return path

    def log_image(self, step, name, image):
        from ipoke_tpu_torch.utils.video import save_image

        return save_image(image, os.path.join(self.log_dir, f"{name}_step{int(step)}.png"))


def read_metrics(log_dir):
    """The records of ``<log_dir>/metrics.jsonl``, in order."""
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def latent_scatter(path, latents: dict, max_points=1000):
    """A 2-D embedding of named latent collections, one colour each, written
    to ``path`` (the reference's log_umap, utils/logging.py:28-49): each
    collection flattened per row, at most ``max_points`` rows of it, embedded
    together by umap-learn's ``UMAP`` where it is installed, else by
    ``utils/umap_lite.UMAPLite``.  Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        from umap import UMAP

        reducer = UMAP()
    except Exception:   # noqa: BLE001  (no umap-learn, or it fails to import: JAX's fallback)
        from ipoke_tpu_torch.utils.umap_lite import UMAPLite

        reducer = UMAPLite()
    all_x = np.concatenate([np.asarray(v).reshape(len(v), -1)[:max_points] for v in latents.values()])
    emb = reducer.fit_transform(all_x)
    fig, ax = plt.subplots(figsize=(6, 6))
    off = 0
    for name, v in latents.items():
        n = min(len(v), max_points)
        ax.scatter(emb[off: off + n, 0], emb[off: off + n, 1], s=3, label=name, alpha=0.5)
        off += n
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
