"""A run's record: the console and a JSONL stream of scalars (the port's
counterpart of ``ipoke_tpu/utils/logging.py``).

``RunLogger(log_dir).log_scalars(step, {...}, prefix)`` appends one line
``{"step", "time", "<prefix><key>": float, ...}`` to
``<log_dir>/metrics.jsonl``, as JAX's does; ``log_video`` / ``log_image``
write media files beside it.  wandb is an optional import: where it is
missing the logger warns and keeps the JSONL sink.  JAX's ``latent_scatter``
(matplotlib, UMAP) waits for ROADMAP queue 1 item 3.
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
