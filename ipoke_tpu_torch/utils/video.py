"""Video writing (the port's copy of ``ipoke_tpu/utils/video.py``'s
``to_uint8`` and ``save_video``): cv2's MP4V writer where cv2 is installed,
else the frames as ``.npy``; frames come in as [-1, 1] float RGB or uint8.
"""
from __future__ import annotations

import os

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
