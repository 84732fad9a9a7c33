"""The port's FID network (``ipoke_tpu_torch/metrics/fid.py``, InceptionV3
at pool3) against the JAX package's ``ipoke_tpu/metrics/fid.py`` on the
CPU: the pools, one Mixed block of each kind A-E on a small spatial input,
the seeded fallback filters bitwise, and the Fréchet distance of the
features.  The whole network at 299^2 is ``-m slow``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.metrics import fid as jfid
from ipoke_tpu.metrics import fvd as jfvd
from ipoke_tpu_torch.metrics import fid
from torch_port_util import CPU, t

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def fallback(tmp_path_factory):
    """Both packages' seeded filters, drawn with $IPOKE_WEIGHTS on an empty
    directory; the caches cleared around, so no other test sees them."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IPOKE_WEIGHTS", str(tmp_path_factory.mktemp("no_weights")))
    caches = (fid.load_params, fid.inception, jfid.load_params)
    for c in caches:
        c.cache_clear()
    yield fid.load_params(), jfid.load_params()
    for c in caches:
        c.cache_clear()
    mp.undo()


def test_load_params_fallback_is_jax(fallback):
    (ours, pretrained), (theirs, jax_pretrained) = fallback
    assert not pretrained and not jax_pretrained
    assert list(ours) == list(theirs) == [u[0] for u in fid._all_units()]
    for name in ours:
        for k in ("w", "b"):
            a, b = ours[name][k], np.asarray(theirs[name][k])
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, k)


@pytest.mark.parametrize("window,stride,pad,kind", [
    ((3, 3), (2, 2), 0, "max"), ((3, 3), (2, 2), 0, "avg"), ((3, 3), (1, 1), 1, "avg")])
def test_pool(window, stride, pad, kind):
    x = np.random.default_rng(0).standard_normal((2, 9, 9, 5)).astype(np.float32)
    ref = jfid._pool(jnp.asarray(x), window, stride, pad, kind)
    np.testing.assert_allclose(fid._pool(t(x), window, stride, pad, kind).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def _jax_block(p, bname, kind, cin, extra, x):
    """A Mixed block in JAX, as ``ipoke_tpu.metrics.fid.pool3_features``
    assembles it from its ``_run_branch`` and ``_pool``."""
    spec = {"A": lambda: jfid._inception_a(cin, extra), "B": lambda: jfid._inception_b(cin),
            "C": lambda: jfid._inception_c(cin, extra), "D": lambda: jfid._inception_d(cin),
            "E": lambda: jfid._inception_e(cin)}[kind]()
    avg = jfid._pool(x, (3, 3), (1, 1), 1, "avg")
    if kind in ("A", "C"):
        outs = [jfid._run_branch(p, f"{bname}.{b}", c, avg if b == "bpool" else x)
                for b, c in spec.items()]
    elif kind in ("B", "D"):
        outs = [jfid._run_branch(p, f"{bname}.{b}", c, x) for b, c in spec.items()]
        outs.append(jfid._pool(x, (3, 3), (2, 2), 0, "max"))
    else:
        def pair(src, a, b):
            return jnp.concatenate([jfid._run_branch(p, f"{bname}.{a}", spec[a], src),
                                    jfid._run_branch(p, f"{bname}.{b}", spec[b], src)], -1)

        outs = [jfid._run_branch(p, f"{bname}.b1x1", spec["b1x1"], x),
                pair(jfid._run_branch(p, f"{bname}.b3x3_1", spec["b3x3_1"], x),
                     "b3x3_2a", "b3x3_2b"),
                pair(jfid._run_branch(p, f"{bname}.b3x3dbl_1", spec["b3x3dbl_1"], x),
                     "b3x3dbl_2a", "b3x3dbl_2b"),
                jfid._run_branch(p, f"{bname}.bpool", spec["bpool"], avg)]
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("block", [b for b in fid.BLOCKS
                                   if b[0] in ("Mixed_5b", "Mixed_6a", "Mixed_6b", "Mixed_7a",
                                               "Mixed_7b")], ids=lambda b: f"{b[0]}-{b[1]}")
def test_block_matches_jax(fallback, block):
    (host, _), _ = fallback
    bname, kind, cin, extra = block
    x = np.random.default_rng(1).random((1, 5, 5, cin)).astype(np.float32)
    ours = fid._block(fid.upload(host, CPU), bname, kind, cin, extra, t(x)).numpy()
    ref = np.asarray(_jax_block(host, bname, kind, cin, extra, jnp.asarray(x)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL * np.abs(ref).max())


def _stand_in(images):
    """Cheap deterministic 16-dim features of each image (pool3's stand-in)."""
    flat = images.reshape(images.shape[0], -1)
    return flat[:, ::max(1, flat.shape[1] // 16)][:, :16]


def test_compute_fid_is_jax_frechet(monkeypatch):
    """compute_fid: the features in batches, the NaN rows dropped, then the
    Fréchet distance of JAX's formula (``metrics/fvd.frechet_distance``)."""
    monkeypatch.setattr(fid, "pool3_features", _stand_in)
    rng = np.random.default_rng(2)
    real = rng.uniform(-1, 1, (24, 8, 8, 3)).astype(np.float32)
    fake = (0.7 * rng.uniform(-1, 1, (24, 8, 8, 3)) + 0.1).astype(np.float32)
    fake[5] = np.nan
    score = fid.compute_fid(real, fake, batch_size=10, device="cpu")
    fr, ff = _stand_in(real), _stand_in(fake)
    ff = ff[np.isfinite(ff).all(axis=1)]
    ref = jfvd.frechet_distance(fr.mean(0), np.cov(fr, rowvar=False),
                                ff.mean(0), np.cov(ff, rowvar=False))
    assert ff.shape[0] == 23 and score == pytest.approx(ref, rel=1e-9)


@pytest.mark.slow
def test_pool3_features_matches_jax(fallback):
    """The whole network on 64^2 images (resized to 299^2 inside) against
    JAX's jitted pool3_features, then compute_fid against JAX's."""
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = fid.pool3_features(t(real)).numpy()
    ref = np.asarray(jax.jit(jfid.pool3_features)(jnp.asarray(real)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL * np.abs(ref).max())
    score = fid.compute_fid(real, fake, batch_size=2, device="cpu")
    assert score == pytest.approx(jfid.compute_fid(real, fake, batch_size=2), rel=1e-3)
