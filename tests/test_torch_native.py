"""The port's native host data engine (``ipoke_tpu_torch/csrc/dataio.cpp``
through ``data/native``) against the JAX package's (``native/dataio.cpp``
on libpng, through ``ipoke_tpu/data/native``) on the CPU, and against the
engine's numpy twins.

JAX's engine is built once for this module into a temporary directory (its
``_BUILD_DIR``/``_SO`` pointed there), so no two test workers write
``native/build/``; the port's builds into ``build/ipoke_tpu_torch/``.

* npy: f4, f8, CHW, and the engine's codes for over capacity and Fortran
  order;
* PNG: files written here with ``zlib`` and ``struct`` in every colour type
  and bit depth libpng reads, bitwise JAX's engine after its resize (and
  the decoded bytes bitwise ``data/image``'s where that reads them); the
  cases where JAX's engine gives other pixels than the image's (Adam7,
  palette + tRNS) and where its resize reads outside the image raise
  ``IOError`` with the reason; the resize up and down within 1e-6 of the
  numpy twin;
* ``load_frames`` on a 2 x 3 batch; ``simulate_pokes`` bitwise JAX's;
* the engine's inflate against ``zlib`` (stored, fixed and dynamic blocks)
  and on corrupted streams;
* ``IperDataset`` under ``IPOKE_NATIVE=1``: the port's examples bitwise
  JAX's.
"""
import re
import struct
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from ipoke_tpu.data import datamodule as jdm
from ipoke_tpu.data import native as jnative
from ipoke_tpu_torch.data import datamodule, image, native
from ipoke_tpu_torch.data.tree import write_tree

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))   # x0, y0, dx, dy of each pass
RESIZE_TOL = 1e-6


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """``ipoke_tpu.data.native`` with its library built in this module's
    temporary directory."""
    d = tmp_path_factory.mktemp("jax_native")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_BUILD_DIR", str(d))
    mp.setattr(jnative, "_SO", str(d / "libipoke_dataio.so"))
    jnative.lib.cache_clear()
    try:
        jnative.lib()
    except (OSError, subprocess.CalledProcessError) as e:
        mp.undo()
        pytest.skip(f"JAX's engine needs g++ and png.h: {getattr(e, 'stderr', e)}")
    yield jnative
    jnative.lib.cache_clear()
    mp.undo()


@pytest.fixture(scope="module")
def port_engine():
    native.lib()
    return native


def test_threads_build_the_engine_once(tmp_path, monkeypatch):
    """The loader's worker threads load their first example at once: on an
    empty build directory they build the engine once and all get the one
    library, and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native._load.cache_clear()
    start = threading.Barrier(4)

    def first(_):
        start.wait()
        return native.lib()

    try:
        with ThreadPoolExecutor(4) as ex:
            libs = list(ex.map(first, range(4)))
        assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
    finally:
        native._load.cache_clear()
    assert all(x is libs[0] for x in libs)


def _code(err):
    return int(re.search(r"\((\d+)", str(err)).group(1))


def _both(fn_j, fn_p):
    """(JAX's result or IOError, the port's result or IOError)."""
    out = []
    for fn in (fn_j, fn_p):
        try:
            out.append(fn())
        except IOError as e:
            out.append(e)
    return out


# ---------------------------------------------------------------------------
# a PNG writer: any colour type, bit depth, filters, Adam7, IDAT split
# ---------------------------------------------------------------------------

def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _pack(samples, depth):
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    flat = samples.reshape(h, w * c).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    out = np.zeros((h, -(-w * c // per)), np.uint8)
    for i in range(w * c):
        out[:, i // per] |= flat[:, i] << (8 - depth * (i % per + 1))
    return out


def _filter(raw, bpp, filters):
    rows, prev = [], np.zeros(raw.shape[1], np.int64)
    for r, row in enumerate(raw.astype(np.int64)):
        t = filters[r % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = (np.zeros_like(row), a, prev, (a + prev) >> 1, paeth)[t]
        rows.append(bytes([t]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(rows)


def write_png(path, samples, ctype, depth=8, palette=None, trns=None, interlace=False,
              filters=(0, 1, 2, 3, 4), level=6, idat_parts=1):
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    subs = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace else [samples])
    data = b"".join(_filter(_pack(s, depth), bpp, filters) for s in subs if s.size)
    z = zlib.compress(data, level)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                               0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    step = -(-len(z) // idat_parts)
    out += b"".join(_chunk(b"IDAT", z[i:i + step]) for i in range(0, len(z), step))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
    return str(path)


_RNG = np.random.default_rng(0)
H, W = 12, 10
PALETTE = _RNG.integers(0, 256, (16, 3))
# name -> write_png's arguments; JAX's engine decodes each as PIL does,
# except 16-bit grey (libpng's strip_16 keeps the high byte, PIL clips)
PNGS = {
    "grey8": dict(samples=_RNG.integers(0, 256, (H, W)), ctype=0),
    "rgb8": dict(samples=_RNG.integers(0, 256, (H, W, 3)), ctype=2),
    "palette8": dict(samples=_RNG.integers(0, 16, (H, W)), ctype=3, palette=PALETTE),
    "palette4": dict(samples=_RNG.integers(0, 16, (H, W)), ctype=3, depth=4, palette=PALETTE),
    "palette2-past-plte": dict(samples=_RNG.integers(0, 4, (H, W)), ctype=3, depth=2,
                               palette=PALETTE[:2]),
    "grey-alpha8": dict(samples=_RNG.integers(0, 256, (H, W, 2)), ctype=4),
    "rgba8": dict(samples=_RNG.integers(0, 256, (H, W, 4)), ctype=6),
    "rgb16": dict(samples=_RNG.integers(0, 65536, (H, W, 3)), ctype=2, depth=16),
    "grey16": dict(samples=_RNG.integers(0, 65536, (H, W)), ctype=0, depth=16),
    "rgba16": dict(samples=_RNG.integers(0, 65536, (H, W, 4)), ctype=6, depth=16),
    "grey1": dict(samples=_RNG.integers(0, 2, (H, W)), ctype=0, depth=1),
    "grey2": dict(samples=_RNG.integers(0, 4, (H, W)), ctype=0, depth=2),
    "grey4-trns": dict(samples=_RNG.integers(0, 16, (H, W)), ctype=0, depth=4,
                       trns=bytes([0, 3])),
    "rgb8-trns": dict(samples=_RNG.integers(0, 256, (H, W, 3)), ctype=2,
                      trns=bytes([0, 1, 0, 2, 0, 3])),
    "rgb8-stored-split": dict(samples=_RNG.integers(0, 256, (H, W, 3)), ctype=2, level=0,
                              idat_parts=3),
}
# name -> (write_png's arguments, the code the port raises)
REFUSED = {
    "rgb8-adam7": (dict(samples=_RNG.integers(0, 256, (H, H, 3)), ctype=2, interlace=True), 6),
    "grey8-adam7": (dict(samples=_RNG.integers(0, 256, (H, H)), ctype=0, interlace=True), 6),
    "palette8-trns": (dict(samples=_RNG.integers(0, 16, (H, H)), ctype=3, palette=PALETTE,
                           trns=bytes([0, 128, 255])), 7),
}


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("name", list(PNGS))
def test_png_matches_jax_engine(tmp_path, jax_engine, port_engine, name):
    """After the resize to a smaller, the same and a larger size: bitwise
    JAX's engine; the decoded bytes are PIL's (grey16: the high byte)."""
    kw = PNGS[name]
    path = write_png(tmp_path / "a.png", **kw)
    for size in (7, H, 25):
        want, got = _both(lambda: jax_engine.load_png(path, size),
                          lambda: port_engine.load_png(path, size))
        assert np.array_equal(got, want), (name, size)
    px = port_engine.decode_png(path)
    if name == "grey16":
        assert np.array_equal(px, np.repeat((kw["samples"] >> 8)[..., None], 3, -1))
    else:
        assert np.array_equal(px, _pil(path))
    if kw.get("depth", 8) == 8:   # data/image reads 8-bit PNGs: the twin
        assert np.array_equal(px, image.read_png(path))
        np.testing.assert_allclose(port_engine.load_png(path, 9),
                                   native.load_png_plain(path, 9), rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("name", list(REFUSED))
def test_png_refuses_where_jax_engine_is_not_the_image(tmp_path, jax_engine, port_engine, name):
    """Adam7 (no interlace handling) and palette + tRNS (RGBA rows copied
    three bytes a pixel): JAX's engine returns pixels that are not PIL's;
    the port raises with the reason."""
    kw, code = REFUSED[name]
    path = write_png(tmp_path / "a.png", **kw)
    ref = _pil(path).astype(np.float32) / 127.5 - 1.0
    assert not np.array_equal(jax_engine.load_png(path, H), ref)   # H x H: no resize
    for fn in (lambda: port_engine.load_png(path, 8), lambda: port_engine.decode_png(path),
               lambda: port_engine.load_frames([[path]], 8)):
        with pytest.raises(IOError) as e:
            fn()
        assert _code(e.value) == code and "JAX engine" in str(e.value)


def test_png_refusals_of_the_resize_and_of_malformed_files(tmp_path, jax_engine, port_engine):
    """One pixel high: JAX's resize would read row -1, so the port raises
    (code 8; JAX's engine is not called on it).  A flipped IDAT CRC, a bad
    row filter, a cut file and a wrong Adler-32 fail in both engines."""
    one = write_png(tmp_path / "one.png", np.zeros((1, 6, 3)), ctype=2)
    with pytest.raises(IOError) as e:
        port_engine.load_png(one, 4)
    assert _code(e.value) == 8
    assert port_engine.decode_png(one).shape == (1, 6, 3)
    # a header of 10^6 x 10^6 RGBA16 over a short stream: not enough image
    # data, found without allocating the image (JAX's engine would allocate it)
    huge = str(tmp_path / "huge.png")
    open(huge, "wb").write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 10**6, 10**6, 16, 6, 0, 0, 0)) + _chunk(b"IDAT", zlib.compress(bytes(99)))
        + _chunk(b"IEND", b""))
    with pytest.raises(IOError) as e:
        port_engine.load_png(huge, 4)
    assert _code(e.value) == 2
    good = open(write_png(tmp_path / "g.png", **PNGS["rgb8"]), "rb").read()
    idat = good.index(b"IDAT")
    n = struct.unpack(">I", good[idat - 4:idat])[0]
    bad_crc = good[:idat + 4 + n] + bytes([good[idat + 4 + n] ^ 1]) + good[idat + 5 + n:]
    z = zlib.decompress(good[idat + 4:idat + 4 + n])
    bad_filter = zlib.compress(bytes([9]) + z[1:])
    bad_adler = good[idat + 4:idat + 4 + n - 1] + bytes([good[idat + 3 + n] ^ 1])
    cases = {"crc": (bad_crc, 2, 2), "filter": (None, 2, 2), "cut": (good[:len(good) // 2], 2, 2),
             "adler": (None, 2, 18)}
    for name, (data, jax_rc, port_rc) in cases.items():
        path = str(tmp_path / f"{name}.png")
        if name == "filter":
            data = good[:idat - 4] + _chunk(b"IDAT", bad_filter) + _chunk(b"IEND", b"")
        if name == "adler":
            data = good[:idat - 4] + _chunk(b"IDAT", bad_adler) + _chunk(b"IEND", b"")
        open(path, "wb").write(data)
        want, got = _both(lambda: jax_engine.load_png(path, 8),
                          lambda: port_engine.load_png(path, 8))
        assert (_code(want) if isinstance(want, IOError) else 0) == jax_rc, name
        assert isinstance(got, IOError) and _code(got) == port_rc, (name, got)


@pytest.mark.parametrize("shape,size", [((16, 16), 5), ((16, 16), 33), ((9, 20), 16)])
def test_resize_within_tolerance_of_the_numpy_twin(tmp_path, port_engine, shape, size):
    img = np.random.default_rng(1).integers(0, 256, shape + (3,))
    path = write_png(tmp_path / "r.png", img, ctype=2)
    np.testing.assert_allclose(port_engine.load_png(path, size),
                               native.load_png_plain(path, size), rtol=0, atol=RESIZE_TOL)


def test_load_frames_matches_jax_engine(tmp_path, jax_engine, port_engine):
    rng = np.random.default_rng(2)
    paths = [[write_png(tmp_path / f"{b}_{t}.png", rng.integers(0, 256, (20, 20, 3)), ctype=2)
              for t in range(3)] for b in range(2)]
    got = port_engine.load_frames(paths, 16)
    assert got.shape == (2, 3, 16, 16, 3)
    assert np.array_equal(got, jax_engine.load_frames(paths, 16))
    assert np.array_equal(got[1, 2], port_engine.load_png(paths[1][2], 16))
    paths[1][1] = str(tmp_path / "missing.png")
    want, got = _both(lambda: jax_engine.load_frames(paths, 16),
                      lambda: port_engine.load_frames(paths, 16))
    assert _code(got) == _code(want) == 1


# ---------------------------------------------------------------------------
# npy flows and pokes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["f4", "f8", "chw", "over-capacity", "fortran"])
def test_npy_flow_matches_jax_engine(tmp_path, jax_engine, port_engine, case):
    rng = np.random.default_rng(3)
    arr = {"f4": lambda: rng.standard_normal((12, 10, 2)).astype(np.float32),
           "f8": lambda: rng.standard_normal((12, 10, 2)),
           "chw": lambda: rng.standard_normal((2, 12, 10)).astype(np.float32),
           "over-capacity": lambda: np.zeros(native.NPY_CAPACITY + 1, np.float32),
           "fortran": lambda: np.asfortranarray(rng.standard_normal((12, 10, 2)))}[case]()
    path = str(tmp_path / "f.npy")
    np.save(path, arr)
    want, got = _both(lambda: jax_engine.load_npy_flow(path),
                      lambda: port_engine.load_npy_flow(path))
    if case in ("over-capacity", "fortran"):
        assert _code(got) == _code(want) == {"over-capacity": 4, "fortran": 3}[case]
        return
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, native.load_npy_flow_plain(path))


@pytest.mark.parametrize("kw", [dict(seed=1), dict(seed=2**40 + 7, n_pokes_max=1),
                                dict(seed=3, zero_poke=True), dict(seed=4, fix_n_pokes=True),
                                dict(seed=5, equal_poke_val=False, poke_size=3)],
                         ids=["default", "one-poke", "zero-poke", "fix-n", "unequal"])
def test_simulate_pokes_bitwise_jax_engine(jax_engine, port_engine, kw):
    """Bitwise JAX's engine.  Example 4's flow is 0: without ``zero_poke``
    no pixel passes the ladder's last rung (the mean), both engines give
    centres -1 and leave its poke unwritten, which JAX's ``np.empty``
    returns as whatever memory held and the port as zeros."""
    rng = np.random.default_rng(4)
    flow = np.zeros((5, 40, 36, 2), np.float32)
    flow[:, 10:24, 12:30] = rng.normal(0, 3, (5, 1, 1, 2))
    flow += rng.normal(0, 0.2, flow.shape).astype(np.float32)
    flow[4] = 0.0
    (wp, wc), (gp, gc) = (e.simulate_pokes(flow, **kw) for e in (jax_engine, port_engine))
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    held = (gc[:, 0, 0] >= 0)
    assert held[:4].all() and held[4] == bool(kw.get("zero_poke"))
    assert gp.dtype == wp.dtype and np.array_equal(gp[held], wp[held])
    assert not gp[~held].any()


# ---------------------------------------------------------------------------
# inflate
# ---------------------------------------------------------------------------

def _block_type(z):
    return (z[2] >> 1) & 3


@pytest.mark.parametrize("how,btype", [("level0", 0), ("fixed", 1), ("level1", 2),
                                        ("level9", 2)])
def test_inflate_matches_zlib(port_engine, how, btype):
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 256, 70000) // 29).astype(np.uint8).tobytes() + bytes(range(256)) * 40
    if how == "fixed":
        c = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
        z = c.compress(data) + c.flush()
    else:
        z = zlib.compress(data, int(how[-1]))
    assert _block_type(z) == btype
    assert port_engine.inflate(z, len(data)) == data


def test_inflate_raises_on_corrupted_streams(port_engine):
    data = bytes(range(256)) * 64
    z = zlib.compress(data, 9)
    corrupt = {8: z[:-1] + bytes([z[-1] ^ 1]),                   # Adler-32
               2: z[:len(z) // 2],                               # cut
               1: bytes([0x79]) + z[1:],                         # header check
               3: z[:2] + bytes([z[2] | 6]) + z[3:],             # block type 3
               9: z}                                             # past the limit
    for code, stream in corrupt.items():
        with pytest.raises(IOError) as e:
            port_engine.inflate(stream, len(data) - 1 if code == 9 else len(data))
        assert _code(e.value) == code, (code, e.value)


# ---------------------------------------------------------------------------
# the datasets under IPOKE_NATIVE=1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tests/test_torch_data.py's tree: 3 videos of 10 frames at 24^2."""
    root = tmp_path_factory.mktemp("tree")
    return write_tree(str(root), n_videos=3, n_frames=10, size=24, gaps=(3, 6), train_videos=2,
                      keypoints=True)


def test_iper_dataset_native_matches_jax(tree, jax_engine, port_engine, monkeypatch):
    """Two training epochs and the val split of ``IperDataset`` with zero
    pokes: the port's batches bitwise JAX's, both through their native
    engines (bilinear frames, not the default LANCZOS)."""
    monkeypatch.setenv("IPOKE_NATIVE", "1")
    cfg = {"dataset": "IperDataset", "meta_path": tree, "spatial_size": [16, 16],
           "max_frames": 3, "batch_size": 2, "n_workers": 1, "zero_poke": True,
           "zero_poke_amount": 3, "augment": False, "seed": 3, "poke_size": 3, "n_pokes": 3}
    want, got = jdm.StaticDataModule(cfg), datamodule.StaticDataModule(cfg)
    for split, epochs in (("train", 2), ("val", 1)):
        w = [b for _ in range(epochs) for b in want.loader(split)]
        g = [b for _ in range(epochs) for b in got.loader(split)]
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (split, k)
    ds = got.datasets["train"]
    start = int(ds.ids[0])
    frames = ds._load_frames(start)
    monkeypatch.delenv("IPOKE_NATIVE")
    assert not np.array_equal(frames, ds._load_frames(start))   # LANCZOS off the engine
