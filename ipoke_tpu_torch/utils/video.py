"""Video and image writing (the port's copy of ``ipoke_tpu/utils/video.py``'s
``to_uint8``, ``save_video``, ``save_image``, ``enrollment`` and
``preprocess_image``, with ``png_bytes`` for images sent over HTTP): videos by
cv2's MP4V writer where cv2 is installed, else as ``.npy``; images as PNG
written with the standard library (``zlib`` + ``struct``), so no image
package is needed.  Frames come in as [-1, 1] float RGB or uint8.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(frames):
    """[-1,1] float -> uint8 RGB (uint8 passes through unchanged)."""
    arr = np.asarray(frames)
    if arr.dtype == np.uint8:
        return arr
    return ((np.clip(arr, -1, 1) + 1.0) * 127.5).astype(np.uint8)


def save_video(frames, path, fps=3):
    """frames: (T, H, W, 3) in [-1,1] or uint8.  Writes an MP4 (cv2 MP4V) at
    ``path``, or, where cv2 is missing or fails, ``<path stem>.npy``.
    Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = to_uint8(frames)
    try:
        import cv2

        h, w = arr.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MP4V"), fps, (w, h))
        for f in arr:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, arr)
        return alt


_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}   # channels -> grey, RGB, RGBA


def _png_chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_rows(arr, filters):
    """The PNG scanlines of (H, W, C) uint8 ``arr``, row r filtered with
    ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth),
    each behind its filter byte."""
    h, w, c = arr.shape
    x = arr.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                 # the pixel to the left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                       # the pixel above
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]             # above-left
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    ftype = np.asarray([filters[r % len(filters)] for r in range(h)], np.uint8)
    pred = np.stack(preds)[ftype, np.arange(h)]
    out = ((x - pred) & 255).astype(np.uint8).reshape(h, w * c)
    return np.concatenate([ftype[:, None], out], axis=1)


def png_bytes(frame, filters=(0,)):
    """frame: (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) in [-1, 1] or uint8
    -> the bytes of an 8-bit PNG of it (grey, RGB or RGBA, as PIL's
    ``fromarray`` writes it).  Any other shape raises.  ``filters``: the PNG
    row filters, cycled over the rows (by default None on every row;
    ``range(5)`` uses all five, as an adaptive encoder such as libpng's
    does)."""
    arr = to_uint8(frame)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _PNG_COLOR_TYPES:
        raise ValueError(f"save_image: a frame of shape {arr.shape} is not an image")
    h, w, c = arr.shape
    rows = _filter_rows(np.ascontiguousarray(arr), tuple(filters))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image(frame, path, filters=(0,)):
    """``png_bytes(frame, filters)`` written to ``path``; returns ``path``."""
    png = png_bytes(frame, filters)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def enrollment(frames, pad=2):
    """A clip as one horizontal film strip, white between frames."""
    arr = to_uint8(frames)
    t, h, w, c = arr.shape
    out = np.full((h, t * (w + pad) - pad, c), 255, np.uint8)
    for i, f in enumerate(arr):
        out[:, i * (w + pad): i * (w + pad) + w] = f
    return out


def preprocess_image(img, multiple=64):
    """``img`` centre-cropped to a multiple of ``multiple`` in height and
    width (the reference's utils/general.py:28-42, for an image a user gives
    the GUI)."""
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    nh = (h // multiple) * multiple
    nw = (w // multiple) * multiple
    top = (h - nh) // 2
    left = (w - nw) // 2
    return arr[top: top + nh, left: left + nw]
