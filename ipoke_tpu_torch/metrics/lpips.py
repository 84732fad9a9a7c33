"""LPIPS perceptual distance (counterpart of ``ipoke_tpu/metrics/lpips.py``;
the reference's LPIPS and the pip ``lpips`` net of utils/metrics.py:418-447).

VGG16 slices (relu1_2 .. relu5_3), channel-unit-normalised features, their
squared difference weighted by a 1x1 linear head per slice, the spatial mean,
summed over slices.  The heads are read from
``$IPOKE_WEIGHTS/lpips_vgg_lins.npz`` (``lin{i}/w``, shape (C_i,)), else
uniform 1/C; the scores count as pretrained only when the VGG16 filters and
the heads both loaded.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ipoke_tpu_torch.metrics import vgg as vgg_mod

# the LPIPS input scaling layer (not imagenet normalisation)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_LIN_CHANNELS = (64, 128, 256, 512, 512)


@lru_cache(maxsize=1)
def _lins():
    """(the five heads as numpy (C_i,), pretrained?)."""
    path = os.path.join(os.environ.get("IPOKE_WEIGHTS", os.path.join("logs", "weights")),
                        "lpips_vgg_lins.npz")
    if os.path.exists(path):
        data = np.load(path)
        return [np.asarray(data[f"lin{i}/w"]) for i in range(5)], True
    return [np.full((c,), 1.0 / c, np.float32) for c in _LIN_CHANNELS], False


def lpips_pretrained():
    """True only when both the VGG16 filters and the linear heads loaded real
    weights; callers mark their scores UNPRETRAINED otherwise."""
    return bool(vgg_mod.vgg16().pretrained and _lins()[1])


def _norm_feat(f, eps=1e-10):
    return f / torch.sqrt((f * f).sum(dim=-1, keepdim=True) + eps)


def _lpips(net, x, y, lins):
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    fx = net.features((x - shift) / scale)
    fy = net.features((y - shift) / scale)
    total = 0.0
    for a, b, w in zip(fx, fy, lins):
        d = (_norm_feat(a) - _norm_feat(b)) ** 2
        total = total + (d * w).sum(dim=-1).mean(dim=(1, 2))
    return total


def lpips(x, y):
    """x, y: (B, H, W, 3) in [-1, 1] -> (B,) distances, ``vgg.FRAME_CHUNK``
    pairs per pass."""
    net, n = vgg_mod.vgg16(), vgg_mod.FRAME_CHUNK
    lins = [torch.from_numpy(np.asarray(w, np.float32)).to(x.device) for w in _lins()[0]]
    return torch.cat([_lpips(net, x[i:i + n], y[i:i + n], lins) for i in range(0, x.shape[0], n)])


def lpips_video(pred, target):
    """(B, T, H, W, 3) -> mean LPIPS over every frame (a 0-dim tensor)."""
    return torch.mean(lpips(pred.flatten(0, 1), target.flatten(0, 1)))
