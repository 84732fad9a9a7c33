"""Train-time augmentations (host-side numpy; the port's copy of
``ipoke_tpu/data/augment.py``, with the same draws from the dataset's
``np.random.Generator`` in the same order):

* color: brightness/contrast/hue/saturation jitter, one draw per *sample*,
  applied to every frame identically.
* geometry: small rotation + translation (``scipy.ndimage.affine_transform``)
  of the frames AND of each flow channel as an image.  Like the reference,
  the flow vectors are not rotated (angles are <= 15 degrees).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AugmentConfig:
    p_col: float = 0.8
    p_geom: float = 0.8
    brightness: float = 0.4
    contrast: float = 0.5
    hue: float = 0.15
    saturation: float = 0.4
    degrees: float = 15.0
    translate: tuple = (0.1, 0.1)


def _rgb_to_hsv(x):
    # x in [0,1], (..., 3)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    mask = mx == r
    h[mask] = ((g - b)[mask] / diff[mask]) % 6
    mask = mx == g
    h[mask] = (b - r)[mask] / diff[mask] + 2
    mask = mx == b
    h[mask] = (r - g)[mask] / diff[mask] + 4
    h = h / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    out = np.zeros(x.shape, x.dtype)
    for idx, (rr, gg, bb) in enumerate([(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]):
        m = i == idx
        out[..., 0][m] = rr[m]
        out[..., 1][m] = gg[m]
        out[..., 2][m] = bb[m]
    return out


def color_jitter(frames: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig):
    """frames: (T,H,W,3) in [-1,1].  One transform draw for the whole clip."""
    if rng.random() > cfg.p_col:
        return frames
    x = (frames + 1.0) / 2.0
    b = rng.uniform(-cfg.brightness, cfg.brightness)
    c = rng.uniform(-cfg.contrast, cfg.contrast)
    s = rng.uniform(-cfg.saturation, cfg.saturation)
    hshift = rng.uniform(-cfg.hue, cfg.hue)
    x = np.clip(x + b, 0, 1)
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    x = np.clip((x - mean) * (1 + c) + mean, 0, 1)
    hsv = _rgb_to_hsv(x)
    hsv[..., 0] = (hsv[..., 0] + hshift) % 1.0
    hsv[..., 1] = np.clip(hsv[..., 1] * (1 + s), 0, 1)
    x = _hsv_to_rgb(hsv)
    return (x * 2.0 - 1.0).astype(frames.dtype)


def _affine_matrix(deg, tx, ty, h, w):
    a = np.deg2rad(deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    offset = np.array([cy, cx]) - rot @ np.array([cy - ty, cx - tx])
    return rot, offset


def geometric(frames: np.ndarray, flows: list, rng: np.random.Generator, cfg: AugmentConfig):
    """Apply one rotation+translation draw to frames (T,H,W,C) and each flow
    map in ``flows`` ((H,W,2) each; warped per channel, vectors untouched)."""
    if rng.random() > cfg.p_geom:
        return frames, flows
    from scipy import ndimage

    t, h, w = frames.shape[:3]
    deg = rng.uniform(-cfg.degrees, cfg.degrees)
    ty = rng.uniform(-cfg.translate[0], cfg.translate[0]) * h
    tx = rng.uniform(-cfg.translate[1], cfg.translate[1]) * w
    rot, offset = _affine_matrix(deg, tx, ty, h, w)

    def warp(img2d):
        return ndimage.affine_transform(img2d, rot, offset=offset, order=1, mode="constant")

    frames_out = np.stack(
        [np.stack([warp(frames[i, ..., c]) for c in range(frames.shape[-1])], -1) for i in range(t)]
    )
    flows_out = [np.stack([warp(f[..., c]) for c in range(f.shape[-1])], -1) for f in flows]
    return frames_out.astype(frames.dtype), flows_out
