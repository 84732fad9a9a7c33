"""Poke simulation from dense optical flow (host-side numpy; the port's
copy of ``ipoke_tpu/data/poke.py``).

Training pokes are sparse 2-channel maps: a (poke_size x poke_size) patch at a
sampled high-motion pixel carries the local flow.  A zero-poke places the
patch on low-motion (background) pixels with a high-motion flow value while
the dataset zeroes the target flow.  The index draws stay on the host, in the
JAX package's order, so the same ``np.random.Generator`` gives the same pokes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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


def _candidate_indices(amplitude: np.ndarray, cfg: PokeConfig):
    """High-motion candidate pixels: amp > mean + 2*std with the reference's
    fallback ladder (mean + std, then mean)."""
    std = amplitude.std()
    mean = amplitude.mean()
    idx = np.argwhere(amplitude > mean + 2.0 * std)
    if idx.shape[0] == 0:
        idx = np.argwhere(amplitude > mean + std)
        if idx.shape[0] == 0:
            idx = np.argwhere(amplitude > mean)
    if idx.shape[0] == 0:
        raise FlowError("no candidate poke positions (flat flow)")
    return idx + np.asarray([[cfg.valid_h[0], cfg.valid_w[0]]])


def _normalized_amplitude(flow: np.ndarray, cfg: PokeConfig):
    """flow: (H, W, 2).  Amplitude over the valid window, min-max normalized."""
    vh, vw = cfg.valid_h, cfg.valid_w
    amp = np.linalg.norm(flow[vh[0]:vh[1], vw[0]:vw[1]], axis=-1)
    amp = amp - amp.min()
    mx = amp.max()
    if mx > 0:
        amp = amp / mx
    return amp


def flow_foreground_mask(flow: np.ndarray, cfg: PokeConfig):
    """Flow-based foreground mask over the valid window: amplitude above
    mean + std of the min-max-normalized amplitude (reference
    base_dataset.py:343-351 _compute_mask_with_flow)."""
    amp = _normalized_amplitude(flow, cfg)
    return amp > amp.mean() + amp.std()


def grabcut_foreground_mask(image_m11: np.ndarray, cfg: PokeConfig,
                            flow_width_factor: int = 5):
    """GrabCut foreground mask of the start frame (reference
    base_dataset.py:327-341 _compute_mask): rectangle prior spanning the
    central (f-2)/f of the width inside the valid window.  Returns a bool
    mask over the VALID window (same frame as flow_foreground_mask)."""
    import cv2

    img = ((image_m11 + 1.0) * 127.5).astype(np.uint8)
    mask = np.zeros(img.shape[:2], np.uint8)
    vh = cfg.valid_h
    rect = (
        int(img.shape[1] / flow_width_factor), int(vh[0]),
        int((flow_width_factor - 2) / flow_width_factor * img.shape[1]),
        int(vh[1] - vh[0]),
    )
    fgm = np.zeros((1, 65), np.float64)
    bgm = np.zeros((1, 65), np.float64)
    mask2, _, _ = cv2.grabCut(img, mask, rect, fgm, bgm, 5, cv2.GC_INIT_WITH_RECT)
    fg = (mask2 == cv2.GC_FGD) | (mask2 == cv2.GC_PR_FGD)
    return fg[cfg.valid_h[0]:cfg.valid_h[1], cfg.valid_w[0]:cfg.valid_w[1]]


def simulate_poke(
    flow: np.ndarray,
    cfg: PokeConfig,
    rng: np.random.Generator,
    zero_poke: bool = False,
    foreground_mask: Optional[np.ndarray] = None,
):
    """Returns (poke (H,W,2), poke_centers (n_pokes_max, 2) with -1 padding).

    ``zero_poke``: patch positions from background (lowest-5%-amplitude)
    pixels; patch values from high-motion pixels.  The caller is responsible
    for zeroing the target flow (the dataset does it via the -1 sampler index,
    base_dataset.py:680-681).

    ``foreground_mask``: bool over the valid window (filter_flow datasets —
    iPER/Taichi): poke candidates only on foreground; zero-poke placement
    prefers explicit background (reference base_dataset.py:520-560)."""
    h, w = flow.shape[:2]
    amp = _normalized_amplitude(flow, cfg)
    amp_filt = np.where(foreground_mask, amp, 0.0) if foreground_mask is not None else amp
    try:
        cand = _candidate_indices(amp_filt, cfg)
    except FlowError:
        if foreground_mask is None:
            raise
        # mask excluded every moving pixel (bad grabcut) — fall back unmasked
        amp_filt = amp
        cand = _candidate_indices(amp, cfg)

    if zero_poke:
        if foreground_mask is not None:
            placement = np.argwhere(~foreground_mask)
            if placement.shape[0] == 0:
                placement = np.argwhere(amp < np.percentile(amp, 5))
        else:
            thresh = np.percentile(amp, 5)
            placement = np.argwhere(amp < thresh)
        if placement.shape[0] == 0:
            placement = np.argwhere(amp <= amp.min())
        placement = placement + np.asarray([[cfg.valid_h[0], cfg.valid_w[0]]])
        # magnitudes from moderately-moving pixels (mean + std ladder)
        std, mean = amp_filt.std(), amp_filt.mean()
        mgn = np.argwhere(amp_filt > mean + std)
        if mgn.shape[0] == 0:
            mgn = np.argwhere(amp_filt > mean)
        if mgn.shape[0] == 0:
            mgn = np.argwhere(amp >= amp.max())
        mgn = mgn + np.asarray([[cfg.valid_h[0], cfg.valid_w[0]]])
    else:
        placement = cand
        mgn = None

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
        if zero_poke:
            vr, vc = int(mrows[n]), int(mcols[n])
        else:
            vr, vc = r, c
        if cfg.equal_poke_val:
            val = flow[vr, vc]  # (2,)
            poke[r - half : r + half + 1, c - half : c + half + 1] = val
        else:
            patch = flow[vr - half : vr + half + 1, vc - half : vc + half + 1]
            poke[r - half : r + half + 1, c - half : c + half + 1] = patch
        centers[n] = (r, c)
    return poke, centers


def keypoint_poke(
    kps_start: np.ndarray,
    kps_end: np.ndarray,
    cfg: PokeConfig,
    rng: np.random.Generator,
    min_displacement: float = 1.0,
):
    """Poke derived from keypoint displacements (reference
    base_dataset.py:462-497 _get_keypoint_poke): choose up to n_pokes moving
    keypoints inside the valid window; patch value = kp_end - kp_start
    (dy, dx).  kps: (K, 2) as (x, y) absolute pixels (pose-net convention).

    Returns (poke (H,W,2), centers (n_pokes,2) row/col with -1 padding)."""
    h, w = cfg.spatial_size
    disp = kps_end - kps_start  # (K, 2) in (dx, dy)
    vh, vw = cfg.valid_h, cfg.valid_w
    valid = (
        (kps_start[:, 0] >= vw[0]) & (kps_start[:, 0] <= vw[1])
        & (kps_start[:, 1] >= vh[0]) & (kps_start[:, 1] <= vh[1])
        & (np.linalg.norm(disp, axis=1) >= min_displacement)
        & (kps_start[:, 0] >= 0) & (kps_start[:, 1] >= 0)
    )
    cand = np.flatnonzero(valid)
    poke = np.zeros((h, w, 2), np.float32)
    centers = np.full((cfg.n_pokes, 2), -1, np.int64)
    if len(cand) == 0:
        return poke, centers
    n = cfg.n_pokes if cfg.fix_n_pokes else int(rng.integers(1, min(cfg.n_pokes, len(cand)) + 1))
    sel = rng.choice(cand, size=min(n, len(cand)), replace=False)
    half = cfg.poke_size // 2
    for i, k in enumerate(sel):
        c, r = int(kps_start[k, 0]), int(kps_start[k, 1])
        val = np.asarray([disp[k, 1], disp[k, 0]], np.float32)  # (dy, dx)
        poke[max(r - half, 0) : r + half + 1, max(c - half, 0) : c + half + 1] = val
        centers[i] = (r, c)
    return poke, centers


def poke_from_coords(
    flow_shape: Tuple[int, int],
    coords: np.ndarray,
    displacements: np.ndarray,
    poke_size: int = 5,
):
    """Inference-time poke from explicit (row, col) coords + (dy, dx) vectors
    — the GUI mouse-drag path (testing/gui.py:326-350)."""
    h, w = flow_shape
    poke = np.zeros((h, w, 2), np.float32)
    half = poke_size // 2
    for (r, c), d in zip(np.atleast_2d(coords), np.atleast_2d(displacements)):
        poke[int(r) - half : int(r) + half + 1, int(c) - half : int(c) + half + 1] = d
    return poke
