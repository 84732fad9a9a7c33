"""Frame decoding and resizing without PIL (numpy and the standard library).

The JAX package loads a frame with PIL: ``Image.open(path).convert("RGB")``,
resized with ``Image.LANCZOS`` when its size is not the dataset's
(``ipoke_tpu/data/datasets.py:_load_image``); its data preparation reads a
frame as ``convert("L").resize((16, 16))`` for the image-space neighbours.
The port does both without PIL, so it depends on neither PIL nor cv2 (the
card's machine has both, but the port does not rely on them):

* ``read_png``: 8-bit, non-interlaced PNG (grey, RGB, palette, grey+alpha,
  RGBA) with the five row filters of the PNG standard, converted to RGB as
  PIL's ``convert("RGB")`` does.  PNG is lossless, so the pixels equal PIL's.
  Rows filtered with None, Sub or Up are undone row by row with numpy; where
  a row uses Average or Paeth, which run along the row, the image is undone
  along its anti-diagonals (every filter reads only the pixels left, above
  and above-left), each diagonal one set of numpy operations.
  ``read_pngs`` undoes the filters of many images of one size together (a
  clip's frames), so each set of operations covers all of them.
* ``to_grey``: PIL's ``convert("L")`` of those pixels, ITU-R 601-2 luma in
  PIL's 16-bit fixed point (``L24`` in ``Convert.c``).
* ``resize_lanczos`` / ``resize``: PIL's two-pass resample (``Resample.c``),
  horizontal then vertical, with the filter's kernel (Lanczos-3, or bicubic
  with a = -0.5) stretched by the scale, its
  coefficients normalised and rounded to 22-bit fixed point, summed in
  int32, and each pass rounded and clipped to uint8.  ``resize`` defaults to
  bicubic, the filter ``Image.resize`` takes for a mode "L" or "RGB" image
  when it is given none.
"""
from __future__ import annotations

import math
import struct
import zlib
from functools import lru_cache

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples per pixel
PRECISION_BITS = 32 - 8 - 2                   # Resample.c's fixed point


def _chunks(data):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, filt):
    """Images whose rows are filtered with None, Sub or Up: ftype (N, H),
    filt (N, H, W, bpp) uint8."""
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[:, 0])
    for r in range(filt.shape[1]):
        t = ftype[:, r, None, None]
        sub = np.cumsum(filt[:, r], axis=1, dtype=np.uint8)
        row = np.where(t == 1, sub, np.where(t == 2, filt[:, r] + prev, filt[:, r]))
        out[:, r] = prev = row
    return out


def _unfilter_diagonals(ftype, filt):
    """Any filters, undone along the anti-diagonals r + p = d: the pixel
    (r, p) reads (r, p-1), (r-1, p) and (r-1, p-1) only, all on the two
    diagonals before its own.  ftype (N, H), filt (N, H, W, bpp).

    The image is skewed so that diagonal d is row d + 2 of ``x`` (pixel
    (r, d - r) at column r + 1; rows 0-1 and column 0 stay zero, as does
    every slot off the image): then (r, p-1) and (r-1, p) are columns r + 1
    and r of row d + 1, and (r-1, p-1) column r of row d, so each diagonal
    reads and writes slices."""
    n, h, w, bpp = filt.shape
    nd = h + w - 1
    r_all = np.arange(h)[:, None]
    d_all = r_all + np.arange(w)[None, :]                      # (H, W): the diagonal of (r, p)
    f = np.zeros((n, nd + 1, h + 1, bpp), np.int16)
    f[:, d_all + 1, r_all + 1] = filt
    t = np.zeros((n, nd + 1, h + 1, 1), np.int8)
    t[:, d_all + 1, r_all + 1, 0] = np.broadcast_to(ftype[:, :, None], (n, h, w))
    x = np.zeros((n, nd + 2, h + 2, bpp), np.int16)            # row 0 and column 0 stay zero
    zero = np.zeros((), np.int16)
    for d in range(nd):
        lo, hi = max(0, d - w + 1) + 1, min(h - 1, d) + 2       # columns r + 1 of this diagonal
        a = x[:, d + 1, lo:hi]                                  # (r, p-1): diagonal d-1, column r+1
        b = x[:, d + 1, lo - 1:hi - 1]                          # (r-1, p): diagonal d-1, column r
        c = x[:, d, lo - 1:hi - 1]                              # (r-1, p-1): diagonal d-2, column r
        tt = np.broadcast_to(t[:, d + 1, lo:hi], a.shape)
        pred = np.choose(tt, (zero, a, b, (a + b) >> 1, _paeth(a, b, c)))
        x[:, d + 2, lo:hi] = (f[:, d + 1, lo:hi] + pred) & 255
    return x[:, d_all + 2, r_all + 1].astype(np.uint8)


def _unfilter(ftype, filt):
    return (_unfilter_diagonals(ftype, filt) if (ftype >= 3).any()
            else _unfilter_rows(ftype, filt))


def _parse_png(data: bytes):
    """(ftype (H,), filtered (H, W, bpp), colour type, palette)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    idat, palette, header = [], None, None
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: only 8-bit non-interlaced images are read")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    ftype, filt = raw[:, 0], raw[:, 1:].reshape(h, w, bpp)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {ftype.max()} is not one of 0-4")
    return ftype, filt, ctype, palette


def _to_rgb(px, ctype, palette):
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    if px.shape[-1] <= 2:             # grey (+ alpha): PIL's "L" -> "RGB"
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])   # RGBA -> RGB drops alpha


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit non-interlaced PNG as (H, W, 3) uint8 RGB.
    Anything else raises ``ValueError``."""
    return decode_pngs([data])[0]


def decode_pngs(datas) -> list:
    """``decode_png`` of each PNG, the filters of images of one shape
    undone together."""
    parsed = [_parse_png(d) for d in datas]
    out = [None] * len(parsed)
    groups = {}
    for i, (ftype, filt, _, _) in enumerate(parsed):
        groups.setdefault(filt.shape, []).append(i)
    for idx in groups.values():
        px = _unfilter(np.stack([parsed[i][0] for i in idx]), np.stack([parsed[i][1] for i in idx]))
        for j, i in enumerate(idx):
            out[i] = _to_rgb(px[j], parsed[i][2], parsed[i][3])
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def read_png(path) -> np.ndarray:
    return decode_png(_read(path))


def _sinc(v):
    v = np.asarray(v, np.float64) * math.pi
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(v == 0.0, 1.0, np.sin(v) / np.where(v == 0.0, 1.0, v))


def _lanczos(x):
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


def _bicubic(x):
    """``bicubic_filter`` with a = -0.5, in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# Resample.c's filters: kernel and support
FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


@lru_cache(maxsize=None)
def resample_taps(in_size: int, out_size: int, filt: str = "lanczos"):
    """PIL's 22-bit fixed-point coefficients of ``filt`` (``precompute_coeffs``
    + ``normalize_coeffs_8bpc``) as taps: (index, weight), each
    (out_size, K) with K the widest support, unused taps weight 0."""
    kernel, support = FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = kernel((np.arange(xmin, xmax) - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in k.tolist():          # summed in order, as the C loop sums
            ww += v
        if ww != 0.0:
            k = k / ww
        q = k * (1 << PRECISION_BITS)
        rows.append((xmin, np.where(q < 0, np.trunc(q - 0.5), np.trunc(q + 0.5))))
    taps = max(len(q) for _, q in rows)
    index = np.zeros((out_size, taps), np.int64)
    weight = np.zeros((out_size, taps), np.float64)
    for xx, (xmin, q) in enumerate(rows):
        index[xx, :len(q)] = np.arange(xmin, xmin + len(q))
        weight[xx, :len(q)] = q
    return index, weight


def _pass(taps, x, axis):
    """One pass along ``axis`` of ``x`` (uint8): the taps' sum from PIL's
    rounding offset in int32, as ``Resample.c`` sums (exact: the weights
    sum to 2**22, so |sum| < 2**31), shifted down and clipped to uint8."""
    index, weight = taps
    xi = x.astype(np.int32)
    shape = [1] * x.ndim
    shape[axis] = weight.shape[0]
    w = weight.astype(np.int32)
    acc = None
    for k in range(index.shape[1]):
        term = w[:, k].reshape(shape) * np.take(xi, index[:, k], axis=axis)
        acc = term if acc is None else acc + term
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size, filt: str = "bicubic") -> np.ndarray:
    """(H, W[, C]) uint8 -> (size[0], size[1][, C]) uint8, as PIL's
    ``resize((size[1], size[0]), filt)`` of that image; (N, H, W, C)
    resizes each image."""
    if img.ndim == 2:
        return resize(img[..., None], size, filt)[..., 0]
    one = img.ndim == 3
    out = img[None] if one else img
    oh, ow = size
    h, w = out.shape[1:3]
    if ow != w:
        out = _pass(resample_taps(w, ow, filt), out, axis=2)
    if oh != h:
        out = _pass(resample_taps(h, oh, filt), out, axis=1)
    out = np.ascontiguousarray(out)
    return out[0] if one else out


def resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """(H, W, C) uint8 -> (size[0], size[1], C) uint8, as PIL's
    ``resize((size[1], size[0]), Image.LANCZOS)``; (N, H, W, C) resizes
    each image."""
    return resize(img, size, "lanczos")


def to_grey(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> (...) uint8, PIL's ``convert("L")``:
    (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    rgb = img.astype(np.int32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _frames(imgs, size):
    """Images of one shape -> (N, size, size, 3) float32 in [-1, 1]."""
    arr = np.stack(imgs)
    if arr.shape[1:3] != (size, size):
        arr = resize_lanczos(arr, (size, size))
    return np.asarray(arr, np.float32) / 127.5 - 1.0


def load_image(path, size: int) -> np.ndarray:
    """A frame as (size, size, 3) float32 in [-1, 1]: the JAX package's
    ``_load_image`` without PIL."""
    return _frames([read_png(path)], size)[0]


def load_images(paths, size: int) -> np.ndarray:
    """``load_image`` of each path, stacked: (N, size, size, 3); the PNGs
    decoded, and resized, together."""
    imgs = decode_pngs([_read(p) for p in paths])
    if len({im.shape for im in imgs}) > 1:
        return np.stack([_frames([im], size)[0] for im in imgs])
    return _frames(imgs, size)
