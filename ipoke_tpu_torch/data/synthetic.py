"""Synthetic poke-video dataset: moving Gaussian blobs with exact dense flow
(the port's copy of ``ipoke_tpu/data/synthetic.py``; numpy only).  The
trainers read it through ``data/datamodule.StaticDataModule`` with
``data.dataset: SyntheticDataset``.

Each example is the batch dict of the real datasets:
  images:     (T, H, W, 3)  in [-1, 1]
  poke:       (H, W, 2)     simulated from the flow
  flow:       (H, W, 2)     frame0 -> frame T-1 displacement (zeroed for
                            zero-pokes)
  sample_ids: scalar id
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ipoke_tpu_torch.data.poke import PokeConfig, simulate_poke


@dataclass
class SyntheticConfig:
    spatial_size: int = 64
    max_frames: int = 10
    n_examples: int = 64
    n_blobs: int = 2
    poke: PokeConfig = field(default_factory=PokeConfig)

    def __post_init__(self):
        self.poke.spatial_size = (self.spatial_size, self.spatial_size)


class SyntheticPokeDataset:
    def __init__(self, cfg: SyntheticConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def __len__(self):
        return self.cfg.n_examples

    def _render(self, centers, colors, sigma, size):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        img = np.full((size, size, 3), -1.0, np.float32)
        for (cy, cx), col in zip(centers, colors):
            g = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)))
            img += g[..., None] * col[None, None]
        return np.clip(img, -1, 1)

    def __getitem__(self, idx):
        zero_poke = idx == -1
        rng = np.random.default_rng(self.seed * 100003 + (int(idx) if not zero_poke else 999983))
        size, t = self.cfg.spatial_size, self.cfg.max_frames
        sigma = size / 10
        starts = rng.uniform(size * 0.3, size * 0.7, (self.cfg.n_blobs, 2))
        vel = rng.uniform(-size * 0.02, size * 0.02, (self.cfg.n_blobs, 2))
        colors = rng.uniform(0.5, 2.0, (self.cfg.n_blobs, 3))
        frames = np.stack([self._render(starts + vel * i, colors, sigma, size) for i in range(t)])
        # dense flow of the blob regions: frame0 -> last displacement field
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        flow = np.zeros((size, size, 2), np.float32)
        for (cy, cx), v in zip(starts, vel):
            w = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)))
            mask = (w > 0.3).astype(np.float32)
            flow[..., 0] += mask * v[0] * (t - 1)
            flow[..., 1] += mask * v[1] * (t - 1)
        poke, _ = simulate_poke(flow, self.cfg.poke, rng, zero_poke=zero_poke)
        if zero_poke:   # still video, zero flow
            frames = np.repeat(frames[:1], t, axis=0)
            flow = np.zeros_like(flow)
        return {
            "images": frames.astype(np.float32),
            "poke": poke.astype(np.float32),
            "flow": flow.astype(np.float32),
            "sample_ids": np.asarray(idx if not zero_poke else -1, np.int64),
        }

