"""Diversity scores over N samples per data point (counterpart of
``ipoke_tpu/metrics/diversity.py``; the reference's utils/metrics.py:74-144
and testing/evaluate_diversity.py).

Each score is the mean pairwise distance over the N samples of each example,
over the pairs of ``itertools.combinations`` in their order:
  vgg   : cosine distance between pooled VGG16 features, per frame
  mse   : pixel MSE
  lpips : LPIPS distance, per frame
Input: samples (n_ex, n_samples, T, H, W, 3) in [-1, 1], a tensor on the
device the scores run on.
"""
from __future__ import annotations

import itertools

import torch

from ipoke_tpu_torch.metrics import lpips as lpips_mod
from ipoke_tpu_torch.metrics import vgg as vgg_mod


def _pairs(n):
    return list(itertools.combinations(range(n), 2))


def div_score_vgg(samples):
    n_ex, n_s, t = samples.shape[:3]
    feats = vgg_mod.vgg16_diversity_features(samples.flatten(0, 2)).reshape(n_ex, n_s, t, -1)
    dists = [1.0 - (feats[:, i] * feats[:, j]).sum(dim=-1) for i, j in _pairs(n_s)]
    return float(torch.stack(dists).mean())


def div_score_mse(samples):
    dists = [((samples[:, i] - samples[:, j]) ** 2).mean(dim=(1, 2, 3, 4))
             for i, j in _pairs(samples.shape[1])]
    return float(torch.stack(dists).mean())


def div_score_lpips(samples):
    dists = [lpips_mod.lpips(samples[:, i].flatten(0, 1), samples[:, j].flatten(0, 1)).mean()
             for i, j in _pairs(samples.shape[1])]
    return float(torch.stack(dists).mean())
