"""The port's native host data engine (``csrc/dataio.cpp``, C++/OpenMP),
bound with ctypes: the JAX package's ``IPOKE_NATIVE=1`` loader
(``native/dataio.cpp`` through ``ipoke_tpu/data/native.py``) with its own
inflate and PNG row filters, so it builds with ``g++`` and OpenMP alone.

The engine is built from the repository's source at first use, with the JAX
engine's compiler flags minus its libraries (``CXX_FLAGS``), into
``build/ipoke_tpu_torch/`` beside the package (listed in ``.gitignore``):
the file name carries a hash of the source, the compiler and the flags, and
the library is written to a temporary file of its own and renamed into
place, so processes that build at once never load a half-written one, and
the threads of one process build and load it one at a time.  A failed
build raises ``NativeBuildError`` with the compiler's output; nothing here
falls back to numpy.

``load_npy_flow``, ``load_png``, ``load_frames`` and ``simulate_pokes``
take the JAX package's arguments and give its results.  ``decode_png`` and
``inflate`` expose the decoder's steps.  ``load_png_plain`` and
``load_npy_flow_plain`` are numpy twins of the engine (``data/image``'s
decode and the engine's float32 resize; ``np.load``) that the tests and the
card's checks hold it against; nothing on the native path calls them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from ipoke_tpu_torch.data import image

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "dataio.cpp"
BUILD_DIR = _PKG.parent / "build" / "ipoke_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.RLock()   # build and load: one thread at a time
NPY_CAPACITY = 4 * 1024 * 1024   # floats: the JAX engine's buffer (ipoke_tpu/data/native.py)

NPY_CODES = {1: "cannot open", 2: "not a .npy file", 3: "not <f4/<f8 in C order, or no shape",
             4: "more than 4 Mi floats", 5: "data shorter than its shape"}
INFLATE_CODES = {1: "not a zlib header of deflate (or a preset dictionary)",
                 2: "truncated stream", 3: "block type 3", 4: "stored block LEN/NLEN mismatch",
                 5: "bad code lengths", 6: "bad code", 7: "distance too far back",
                 8: "Adler-32 mismatch", 9: "more output than the limit"}
PNG_CODES = {1: "cannot open", 2: "malformed PNG (signature, chunk, CRC, IHDR, filter or data)",
             5: "the image's buffers cannot be allocated",
             6: "Adam7-interlaced PNG: the JAX engine reads it without interlace handling, so "
                "its pixels are not the image's",
             7: "palette PNG with tRNS: the JAX engine expands it to RGBA and copies three "
                "bytes a pixel, so its pixels are not the image's",
             8: "image under 2 pixels high or wide: the JAX engine's resize reads outside it",
             9: "buffer smaller than the image",
             **{10 + k: f"zlib stream: {v}" for k, v in INFLATE_CODES.items()}}


class NativeBuildError(RuntimeError):
    """The engine did not build; the message holds the compiler's output."""


@dataclass
class BuildInfo:
    path: Path
    seconds: float   # 0.0 when an existing library was reused
    log: str


def library_path() -> Path:
    h = hashlib.sha1(" ".join((CXX,) + tuple(CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libipoke_dataio-{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Build the engine with ``CXX`` and ``CXX_FLAGS`` unless it is built;
    raises ``NativeBuildError``.  Threads of one process build one at a
    time (the loader's workers load their first example at once); processes
    each write a temporary file of their own and rename it into place."""
    with _LOCK:
        path = library_path()
        if path.is_file():
            return BuildInfo(path, 0.0, "")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=path.stem + ".", suffix=".tmp")
        os.close(fd)
        cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp]
        t0 = time.perf_counter()
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:   # no such compiler
                raise NativeBuildError(f"native engine: {' '.join(cmd)} failed to start: "
                                       f"{e}") from e
            if proc.returncode != 0:
                raise NativeBuildError(f"native engine: {' '.join(cmd)} exited "
                                       f"{proc.returncode}:\n{proc.stderr}{proc.stdout}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return BuildInfo(path, time.perf_counter() - t0, proc.stderr + proc.stdout)


_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
SIGNATURES = {
    "ipoke_load_npy_flow": ([ctypes.c_char_p, _P, _I64, _P, _P], _I),
    "ipoke_load_png": ([ctypes.c_char_p, _P, _I, _I], _I),
    "ipoke_load_frames": ([_P, _I, _I, _I, _I, _P], _I),
    "ipoke_simulate_pokes": ([_P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_uint64, _P, _P],
                             None),
    "ipoke_decode_png": ([ctypes.c_char_p, _P, _I64, _P, _P], _I),
    "ipoke_inflate": ([_P, _I64, _P, _I64, _P], _I),
}


@lru_cache(maxsize=None)
def _load(cxx, flags):
    """The library that ``build`` makes with compiler ``cxx`` and ``flags``
    (the cache's key: a test that points ``CXX`` elsewhere builds anew)."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def lib():
    """The engine's library (built by ``CXX`` with ``CXX_FLAGS``), built
    first if needed; loaded once per compiler and flags."""
    with _LOCK:
        return _load(CXX, tuple(CXX_FLAGS))


def available() -> bool:
    try:
        lib()
    except NativeBuildError:
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _path(p) -> bytes:
    return os.fsencode(os.fspath(p))


def load_npy_flow(path):
    """A ``.npy`` of ``<f4`` or ``<f8`` in C order as float32 (the JAX
    engine's ``load_npy_flow``); ``IOError`` with the engine's code."""
    out = np.empty(NPY_CAPACITY, np.float32)
    dims = np.zeros(4, np.int64)
    ndim = ctypes.c_int(0)
    rc = lib().ipoke_load_npy_flow(_path(path), _ptr(out), NPY_CAPACITY, _ptr(dims),
                                   ctypes.byref(ndim))
    if rc != 0:
        raise IOError(f"npy load failed ({rc}: {NPY_CODES.get(rc, '?')}): {path}")
    shape = tuple(int(d) for d in dims[:ndim.value])
    return out[:int(np.prod(shape))].reshape(shape).copy()


def _size(size):
    size = int(size)
    if size < 1:
        raise ValueError(f"output size {size} < 1")
    return size


def load_png(path, size):
    """A PNG as (size, size, 3) float32 in [-1, 1] (the JAX engine's
    ``load_png``); ``IOError`` with the engine's code."""
    size = _size(size)
    out = np.empty((size, size, 3), np.float32)
    rc = lib().ipoke_load_png(_path(path), _ptr(out), size, size)
    if rc != 0:
        raise IOError(f"png load failed ({rc}: {PNG_CODES.get(rc, '?')}): {path}")
    return out


def load_frames(paths_2d, size):
    """paths_2d: list of lists (batch x T) of PNG paths -> (B, T, S, S, 3)
    float32, OpenMP over the frames (the JAX engine's ``load_frames``)."""
    size = _size(size)
    b, t = len(paths_2d), len(paths_2d[0])
    if any(len(row) != t for row in paths_2d):
        raise ValueError("load_frames: every example needs the same number of frames")
    flat = [_path(p) for row in paths_2d for p in row]
    arr = (ctypes.c_char_p * len(flat))(*flat)
    out = np.empty((b, t, size, size, 3), np.float32)
    rc = lib().ipoke_load_frames(ctypes.cast(arr, ctypes.c_void_p), b, t, size, size, _ptr(out))
    if rc != 0:
        raise IOError(f"frame batch load failed ({rc}: {PNG_CODES.get(rc, '?')})")
    return out


def simulate_pokes(flows, poke_size=5, n_pokes_max=5, fix_n_pokes=False,
                   equal_poke_val=True, zero_poke=False, seed=0):
    """flows: (B, H, W, 2) f32 -> (pokes (B, H, W, 2), centers (B,
    n_pokes_max, 2)), the JAX engine's ``simulate_pokes``: example b draws
    from ``mt19937_64(seed + 7919 b)``.  An example with no poke (a flow
    of one amplitude, not ``zero_poke``) has centres -1 and a zero poke;
    the engine leaves it unwritten, and JAX's ``np.empty`` holds whatever
    memory held."""
    flows = np.ascontiguousarray(flows, np.float32)
    if flows.ndim != 4 or flows.shape[-1] != 2:
        raise ValueError(f"flows of shape {flows.shape}, not (B, H, W, 2)")
    b, h, w, _ = flows.shape
    if min(h, w) <= 2 * poke_size or n_pokes_max < 1:
        raise ValueError(f"flows of {h}x{w} leave no window inside poke_size {poke_size}")
    pokes = np.zeros_like(flows)
    centers = np.empty((b, n_pokes_max, 2), np.int64)
    lib().ipoke_simulate_pokes(_ptr(flows), b, h, w, poke_size, n_pokes_max, int(fix_n_pokes),
                               int(equal_poke_val), int(zero_poke), seed, _ptr(pokes),
                               _ptr(centers))
    return pokes, centers


def decode_png(path) -> np.ndarray:
    """The engine's decode of a PNG: (H, W, 3) uint8 RGB."""
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    probe = np.empty(1, np.uint8)
    rc = lib().ipoke_decode_png(_path(path), _ptr(probe), 0, ctypes.byref(h), ctypes.byref(w))
    if rc == 9:
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = lib().ipoke_decode_png(_path(path), _ptr(out), out.size, ctypes.byref(h),
                                    ctypes.byref(w))
        if rc == 0:
            return out
    raise IOError(f"png decode failed ({rc}: {PNG_CODES.get(rc, '?')}): {path}")


def inflate(data: bytes, limit: int) -> bytes:
    """The engine's inflate of a zlib stream of at most ``limit`` bytes out."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(int(limit), 1), np.uint8)
    n = ctypes.c_int64(0)
    rc = lib().ipoke_inflate(_ptr(src), src.size, _ptr(out), int(limit), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"inflate failed ({rc}: {INFLATE_CODES.get(rc, '?')})")
    return out[:n.value].tobytes()


# ---------------------------------------------------------------------------
# numpy twins
# ---------------------------------------------------------------------------

def resize_plain(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (out_h, out_w, 3) float32 in [-1, 1]: the engine's
    bilinear (align_corners) resize in float32, its order of operations."""
    h, w = img.shape[:2]
    f32 = np.float32

    def axis(n_out, n_in):
        o = np.arange(n_out, dtype=f32)
        s = np.zeros(n_out, f32) if n_out == 1 else o * f32(n_in - 1) / f32(n_out - 1)
        i0 = np.minimum(s.astype(np.int64), n_in - 2)
        return i0, s - i0.astype(f32)

    y0, fy = axis(out_h, h)
    x0, fx = axis(out_w, w)
    fy, fx = fy[:, None, None], fx[None, :, None]
    v = img.astype(f32)
    v00, v01 = v[y0][:, x0], v[y0][:, x0 + 1]
    v10, v11 = v[y0 + 1][:, x0], v[y0 + 1][:, x0 + 1]
    one = f32(1)
    out = (v00 * (one - fy) * (one - fx) + v01 * (one - fy) * fx
           + v10 * fy * (one - fx) + v11 * fy * fx)
    return out / f32(127.5) - one


def load_png_plain(path, size) -> np.ndarray:
    """``load_png``'s numpy twin: ``data/image.read_png`` (8-bit,
    non-interlaced PNGs) and ``resize_plain``."""
    return resize_plain(image.read_png(path), _size(size), _size(size))


def load_npy_flow_plain(path) -> np.ndarray:
    """``load_npy_flow``'s numpy twin."""
    return np.load(path).astype(np.float32)
