"""Synthetic poke-video dataset: moving Gaussian blobs with exact dense flow
(the port's copy of ``ipoke_tpu/data/synthetic.py`` and of the poke
simulation in ``ipoke_tpu/data/poke.py``; numpy only).

Each example is the batch dict of the real datasets:
  images:     (T, H, W, 3)  in [-1, 1]
  poke:       (H, W, 2)     simulated from the flow
  flow:       (H, W, 2)     frame0 -> frame T-1 displacement (zeroed for
                            zero-pokes)
  sample_ids: scalar id
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass
class PokeConfig:
    poke_size: int = 5
    n_pokes: int = 5
    fix_n_pokes: bool = False
    equal_poke_val: bool = True
    spatial_size: Tuple[int, int] = (128, 128)

    @property
    def valid_h(self):
        return (self.poke_size, self.spatial_size[0] - self.poke_size)

    @property
    def valid_w(self):
        return (self.poke_size, self.spatial_size[1] - self.poke_size)


class FlowError(Exception):
    pass


def _candidate_indices(amplitude, cfg: PokeConfig):
    """High-motion pixels: amp > mean + 2 std, else > mean + std, else > mean."""
    std, mean = amplitude.std(), amplitude.mean()
    idx = np.argwhere(amplitude > mean + 2.0 * std)
    if idx.shape[0] == 0:
        idx = np.argwhere(amplitude > mean + std)
        if idx.shape[0] == 0:
            idx = np.argwhere(amplitude > mean)
    if idx.shape[0] == 0:
        raise FlowError("no candidate poke positions (flat flow)")
    return idx + np.asarray([[cfg.valid_h[0], cfg.valid_w[0]]])


def _normalized_amplitude(flow, cfg: PokeConfig):
    """flow: (H, W, 2).  Amplitude over the valid window, min-max normalised."""
    vh, vw = cfg.valid_h, cfg.valid_w
    amp = np.linalg.norm(flow[vh[0]:vh[1], vw[0]:vw[1]], axis=-1)
    amp = amp - amp.min()
    mx = amp.max()
    if mx > 0:
        amp = amp / mx
    return amp


def simulate_poke(flow, cfg: PokeConfig, rng: np.random.Generator, zero_poke: bool = False):
    """(poke (H,W,2), poke_centers (n_pokes, 2) with -1 padding): patches of
    ``poke_size`` at high-motion pixels carrying the flow there.  A zero-poke
    places the patches on the lowest-5%-amplitude pixels with the values of
    moving ones; the caller zeroes the target flow."""
    amp = _normalized_amplitude(flow, cfg)
    cand = _candidate_indices(amp, cfg)
    offset = np.asarray([[cfg.valid_h[0], cfg.valid_w[0]]])
    if zero_poke:
        placement = np.argwhere(amp < np.percentile(amp, 5))
        if placement.shape[0] == 0:
            placement = np.argwhere(amp <= amp.min())
        placement = placement + offset
        std, mean = amp.std(), amp.mean()
        mgn = np.argwhere(amp > mean + std)
        if mgn.shape[0] == 0:
            mgn = np.argwhere(amp > mean)
        if mgn.shape[0] == 0:
            mgn = np.argwhere(amp >= amp.max())
        mgn = mgn + offset
    else:
        placement = cand

    n_max = cfg.n_pokes
    if cfg.fix_n_pokes or n_max == 1:
        n_pokes = n_max
    else:
        n_pokes = int(rng.integers(1, min(n_max, placement.shape[0]) + 1))
    sel = rng.integers(0, placement.shape[0], size=n_pokes)
    rows, cols = placement[sel, 0], placement[sel, 1]
    if zero_poke:
        sel_m = rng.integers(0, mgn.shape[0], size=n_pokes)
        mrows, mcols = mgn[sel_m, 0], mgn[sel_m, 1]

    half = cfg.poke_size // 2
    poke = np.zeros_like(flow)
    centers = np.full((n_max, 2), -1, np.int64)
    for n in range(n_pokes):
        r, c = int(rows[n]), int(cols[n])
        vr, vc = (int(mrows[n]), int(mcols[n])) if zero_poke else (r, c)
        if cfg.equal_poke_val:
            poke[r - half:r + half + 1, c - half:c + half + 1] = flow[vr, vc]
        else:
            poke[r - half:r + half + 1, c - half:c + half + 1] = \
                flow[vr - half:vr + half + 1, vc - half:vc + half + 1]
        centers[n] = (r, c)
    return poke, centers


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


def from_data_config(data_cfg: dict, train: bool = True) -> SyntheticPokeDataset:
    """The synthetic dataset of a config's ``data:`` section (train split:
    seed ``data.seed``, other splits ``data.seed + 1``)."""
    ss = data_cfg.get("spatial_size", (64, 64))
    ss = ss[0] if isinstance(ss, (tuple, list)) else ss
    cfg = SyntheticConfig(
        spatial_size=int(ss), max_frames=int(data_cfg.get("max_frames", 10)),
        n_examples=int(data_cfg.get("n_examples", 64)),
        poke=PokeConfig(poke_size=int(data_cfg.get("poke_size", 5)),
                        n_pokes=int(data_cfg.get("n_pokes", 5))))
    return SyntheticPokeDataset(cfg, seed=int(data_cfg.get("seed", 0)) + (0 if train else 1))


def train_batches(dataset, batch_size: int, seed: int = 0):
    """Endless numpy batches of ``batch_size`` (``drop_last``), each epoch in
    the order of a permutation from ``np.random.default_rng(seed)``.

    JAX's ``FixedLengthSampler`` adds zero-poke examples (index -1) to the
    order; that, and the real datasets, come with the data path (ROADMAP
    queue 1 item 7)."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n < batch_size:
        raise ValueError(f"{n} examples cannot fill a batch of {batch_size}")
    while True:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            samples = [dataset[int(i)] for i in order[start:start + batch_size]]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def eval_batches(dataset, batch_size: int):
    """The batches of a validation or test split, as JAX's loader gives them
    there: in index order, the last partial batch dropped."""
    for start in range(0, len(dataset) - batch_size + 1, batch_size):
        samples = [dataset[i] for i in range(start, start + batch_size)]
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class SyntheticDataModule:
    """The validation and test loaders of a config's ``data:`` section on
    the synthetic dataset, as JAX's ``StaticDataModule.loader`` gives them
    there: ``from_data_config(cfg, train=False)`` (seed ``data.seed + 1``)
    in index order, ``data.batch_size`` per batch, the last partial batch
    dropped.  Training draws from ``train_batches``."""

    def __init__(self, data_cfg: dict):
        name = data_cfg.get("dataset", "SyntheticDataset")
        if name != "SyntheticDataset":
            raise NotImplementedError(f"dataset {name!r}: the real datasets come with the data "
                                      "path (ROADMAP queue 1 item 6)")
        self.cfg = data_cfg
        self.batch_size = int(data_cfg.get("batch_size", 8))
        self._eval = None

    def loader(self, split):
        if split not in ("val", "test"):
            raise ValueError(f"SyntheticDataModule.loader: split {split!r} is not 'val' or 'test'")
        if self._eval is None:
            self._eval = from_data_config(self.cfg, train=False)
        return eval_batches(self._eval, self.batch_size)
