"""Frechet Video Distance (counterpart of ``ipoke_tpu/metrics/fvd.py``; the
reference's utils/metrics.py:335-378, 625-780).

The I3D features run batched on the videos' device; the moments and the
Frechet distance (``scipy.linalg.sqrtm`` of the covariance product) run on
the host in float64, the JAX package's code line for line, NaN-row filter
included.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from scipy import linalg

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.metrics import i3d


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """(the reference's calculate_frechet_distance, utils/metrics.py:625-678)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _moments(feats: np.ndarray):
    total = feats.shape[0]
    feats = feats[np.isfinite(feats).all(axis=1)]   # the reference's NaN filter (:735-741)
    if feats.shape[0] < 2:
        # NaN moments would send linalg.sqrtm into an endless loop: fail loudly
        raise ValueError(
            f"FVD: only {feats.shape[0]}/{total} finite feature rows after "
            "NaN filtering; model output is likely non-finite")
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _on(videos, device):
    """``videos`` (a tensor or numpy) as an f32 tensor on ``device``; with
    ``device`` None a tensor stays where it is and numpy goes to the card."""
    if not isinstance(videos, torch.Tensor):
        videos = torch.from_numpy(np.asarray(videos, np.float32))
        device = resolve_device(device)
    return videos.to(device if device is not None else videos.device, torch.float32)


def _features(videos):
    return i3d.features(videos).cpu().numpy()


def compute_features(videos, batch_size=16, device=None):
    """videos: (N, T, H, W, 3) in [-1, 1] -> ((N, 400) numpy, pretrained?)."""
    out = [_features(_on(videos[i:i + batch_size], device))
           for i in range(0, videos.shape[0], batch_size)]
    return np.concatenate(out, axis=0), i3d.i3d().pretrained


def compute_fvd(real_videos, fake_videos, batch_size=16, device=None):
    """FVD between two video sets (N, T, H, W, 3) in [-1, 1]."""
    feats_real, _ = compute_features(real_videos, batch_size, device)
    feats_fake, _ = compute_features(fake_videos, batch_size, device)
    return frechet_distance(*_moments(feats_real), *_moments(feats_fake))


class FVDAccumulator:
    """FVD over validation or test batches: each ``update`` keeps the I3D
    features of its real and fake videos (N x 400 floats), not the videos.

    ``device``: where the features run (None: a tensor's own device, the
    card for numpy).  ``feature_s`` and ``frechet_s`` sum the host seconds
    of the features (to their copy on the host) and of ``compute``."""

    def __init__(self, n_samples=1000, batch_size=16, device=None):
        self.n_samples = n_samples
        self.batch_size = batch_size
        self.device = device
        self._real, self._fake = [], []
        self.pretrained = i3d.i3d().pretrained
        self.feature_s = self.frechet_s = 0.0

    def update(self, real, fake):
        if sum(x.shape[0] for x in self._real) >= self.n_samples:
            return
        t0 = time.perf_counter()
        self._real.append(_features(_on(real, self.device)))
        self._fake.append(_features(_on(fake, self.device)))
        self.feature_s += time.perf_counter() - t0

    def compute(self):
        t0 = time.perf_counter()
        r = np.concatenate(self._real)[: self.n_samples]
        f = np.concatenate(self._fake)[: self.n_samples]
        # the NaN rows the reference drops quietly, counted for the caller
        self.n_dropped_real = int(np.sum(~np.isfinite(r).all(axis=1)))
        self.n_dropped_fake = int(np.sum(~np.isfinite(f).all(axis=1)))
        score = frechet_distance(*_moments(r), *_moments(f))
        self.frechet_s += time.perf_counter() - t0
        return score

    def reset(self):
        self._real, self._fake = [], []
