"""Visualisation in numpy: flow colour maps, poke arrows and sample video
grids (the port's copy of ``ipoke_tpu/utils/vis.py``; the reference's
utils/logging.py:121-519 make_flow_video_with_samples, vis_flow,
make_temporal_border and make_multipoke_grid).

Arrows and labels are drawn with cv2 where it is installed; without it an
arrow becomes its poke's pixels in the arrow colour and a label is left out,
as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ipoke_tpu_torch.utils.video import to_uint8


def flow_to_color(flow, max_mag=None):
    """(H, W, 2) flow -> (H, W, 3) uint8 HSV colour map (hue the direction,
    full saturation, value the magnitude over ``max_mag``, else over the
    largest magnitude)."""
    fy, fx = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx**2 + fy**2)
    ang = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)
    mm = max_mag or (mag.max() + 1e-8)
    val = np.clip(mag / mm, 0, 1)
    hsv = np.stack([ang, np.ones_like(ang), val], -1)
    i = np.floor(hsv[..., 0] * 6).astype(int) % 6
    f = hsv[..., 0] * 6 - np.floor(hsv[..., 0] * 6)
    v = hsv[..., 2]
    p = np.zeros_like(v)
    q = v * (1 - f)
    t = v * f
    # the sector masks carry a channel axis: JAX's (H, W) masks against
    # (H, W, 3) choices do not broadcast, and its np.select raises there
    sector = i[..., None]
    rgb = np.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4, sector == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
         np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1)],
    )
    return (rgb * 255).astype(np.uint8)


def draw_poke_arrows(image, poke, color=(255, 0, 0)):
    """``image`` ([-1, 1] float or uint8, (H, W, 3)) as uint8 with an arrow
    from each poked 8x8 cell along its (dy, dx), or, without cv2, the poked
    pixels set to ``color``."""
    img = to_uint8(image).copy()
    ys, xs = np.nonzero(np.abs(poke).sum(-1))
    if len(ys) == 0:
        return img
    try:
        import cv2

        seen = set()
        for y, x in zip(ys, xs):
            cell = (y // 8, x // 8)
            if cell in seen:
                continue
            seen.add(cell)
            dy, dx = poke[y, x]
            cv2.arrowedLine(img, (int(x), int(y)), (int(x + dx), int(y + dy)), color, 1, tipLength=0.3)
    except Exception:   # noqa: BLE001  (no cv2, or cv2 refuses: the markers, as JAX's)
        img[ys, xs] = color
    return img


def make_sample_grid(x0, samples, gt, flow, poke, max_cols=8):
    """Animated comparison grid: rows [input with poke arrows, sample 1..N,
    ground truth, flow colour map], one column per example.

    x0: (B, H, W, 3); samples: (N, B, T, H, W, 3); gt: (B, T, H, W, 3);
    flow, poke: (B, H, W, 2).  Returns (T, H * rows, W * cols, 3) uint8."""
    n, b, t, h, w, _ = samples.shape
    b = min(b, max_cols)
    rows = []
    inp = np.stack([draw_poke_arrows(x0[i], poke[i]) for i in range(b)], 0)
    rows.append(np.repeat(inp[None], t, axis=0))
    for s in range(n):
        rows.append(to_uint8(samples[s, :b]).transpose(1, 0, 2, 3, 4))
    rows.append(to_uint8(gt[:b]).transpose(1, 0, 2, 3, 4))
    fl = np.stack([flow_to_color(flow[i]) for i in range(b)], 0)
    rows.append(np.repeat(fl[None], t, axis=0))
    return np.concatenate([np.concatenate(list(r), axis=-2) for r in rows], axis=-3)


def _label_row(frames, text):
    """``frames`` with ``text`` and each frame's number burnt in (the
    reference's put_text_to_video_row); unchanged without cv2."""
    try:
        import cv2
    except Exception:   # noqa: BLE001  (no cv2: no label, as JAX's)
        return frames
    out = frames.copy()
    for i, f in enumerate(out):
        cv2.putText(f, text, (3, 12), cv2.FONT_HERSHEY_SIMPLEX, 0.35, (255, 255, 255), 1)
        cv2.putText(f, str(i), (3, f.shape[0] - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.35,
                    (255, 255, 255), 1)
    return out


def _grid_divisors(n):
    """(n_cols, n_rows) with n_cols * n_rows == n, as square as possible."""
    best = (n, 1)
    for c in range(1, int(np.sqrt(n)) + 1):
        if n % c == 0:
            best = (n // c, c)
    return best


def make_multipoke_grid(x0, pokes, gt_vid, sample_vids, n_padded=4):
    """The control_sensitivity overview: x0 (H, W, 3) in [-1, 1]; pokes
    (K, H, W, 2), one per sample video; gt_vid (T, H, W, 3); sample_vids
    (K, T, H, W, 3).

    Each row is [the start frame with its poke's arrows x n_padded, the start
    frame, the frames], with temporal borders; the ground truth's row leads.
    Returns (rows, labelled grid, unlabelled grid) as uint8 videos."""
    src = to_uint8(x0)
    rows_unlabeled, rows_labeled = [], []
    gt = np.concatenate([np.repeat(src[None], n_padded + 1, 0), to_uint8(gt_vid)], 0)
    gt = temporal_border(gt)
    rows_unlabeled.append(gt)
    rows_labeled.append(_label_row(gt, "GT"))
    for i, (p, vid) in enumerate(zip(pokes, sample_vids)):
        fp = draw_poke_arrows(x0, p)
        row = np.concatenate([np.repeat(fp[None], n_padded, 0), src[None], to_uint8(vid)], 0)
        row = temporal_border(row)
        rows_unlabeled.append(row)
        rows_labeled.append(_label_row(row, f"Sample #{i + 1}"))
    n_cols, n_rows = _grid_divisors(len(rows_unlabeled))

    def grid(rows):
        return np.concatenate(
            [np.concatenate(rows[r * n_cols: (r + 1) * n_cols], axis=2) for r in range(n_rows)],
            axis=1)

    return rows_unlabeled, grid(rows_labeled), grid(rows_unlabeled)


def temporal_border(frames, width=2, color_first=(0, 255, 0), color_rest=(255, 0, 0)):
    """uint8 ``frames`` with a border of ``width`` pixels: green on the first
    frame, red on the rest."""
    arr = to_uint8(frames).copy()
    for i, f in enumerate(arr):
        c = color_first if i == 0 else color_rest
        f[:width] = c
        f[-width:] = c
        f[:, :width] = c
        f[:, -width:] = c
    return arr
