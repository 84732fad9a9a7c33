"""The port's metrics (``ipoke_tpu_torch/metrics``) against the JAX package's
on the CPU, function by function, on the same seeded numpy inputs.  Both
packages run their seeded VGG16, LPIPS heads and I3D filters (no weights are
in the repository); the weights path is held to JAX's separately.

Tolerances, each relative to 1 + max|ref|, about ten times the largest
error measured here:
* PSNR, SSIM, best-of-N: 1e-6 (measured up to 1.5e-7: f32 sums in another
  order);
* VGG16 taps, LPIPS, the diversity features and scores, I3D units and
  inception blocks and whole I3D features: 2e-5 (measured up to 2.0e-6 at
  VGG16's deepest taps, 4.8e-7 for whole I3D features: convs summed in
  another order); the max-pools exactly;
* the Frechet distance and the moments on identical features: 1e-12
  (the same float64 code).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.metrics import diversity as jdiv
from ipoke_tpu.metrics import fvd as jfvd
from ipoke_tpu.metrics import i3d as ji3d
from ipoke_tpu.metrics import image as jimage
from ipoke_tpu.metrics import lpips as jlpips
from ipoke_tpu.metrics import vgg as jvgg
from ipoke_tpu_torch.metrics import diversity, fvd, i3d, image, lpips, vgg
from torch_port_util import t

IMG_TOL = 1e-6
NET_TOL = 2e-5
F64_TOL = 1e-12


def _err(got, ref):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / (1 + np.abs(ref).max()))


def _videos(seed, shape):
    """Smooth-ish frames in [-1, 1]: tanh of a normal draw."""
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    """Two video sets (B, T, 24, 24, 3), the second near the first."""
    a = _videos(0, (2, 3, 24, 24, 3))
    b = np.clip(a + 0.2 * np.random.default_rng(1).standard_normal(a.shape), -1, 1).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# image metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["psnr", "ssim", "ssim_video", "ssim_per_frame"])
def test_image_metrics_match_jax(clips, fn):
    """``ssim_per_frame``: JAX's run_accuracy takes ``vmap`` of ``ssim`` over single frames."""
    a, b = clips
    if fn != "ssim_video":
        a, b = a[:, 0], b[:, 0]
    got = getattr(image, fn)(t(a), t(b))
    if fn == "ssim_per_frame":
        ref = jax.vmap(lambda x, y: jimage.ssim(x[None], y[None]))(jnp.asarray(a), jnp.asarray(b))
        assert tuple(got.shape) == (a.shape[0],)
    else:
        ref = getattr(jimage, fn)(jnp.asarray(a), jnp.asarray(b))
        assert got.dim() == 0
    assert _err(got, ref) <= IMG_TOL


def test_ssim_window_is_jax_gaussian():
    assert _err(image._gaussian_kernel(), jimage._gaussian_kernel()) <= 1e-7


def test_best_of_n_metric_matches_jax(clips):
    """Three samples of which two tie on example 0 (the first wins, as in
    JAX's argmin) and the per-frame std is the population std."""
    a, target = clips
    samples = np.stack([a, a, np.clip(-a, -1, 1)])
    samples[1, 1] = target[1]                       # example 1: sample 1 is exact

    def mse_t(x, y):
        return ((x - y) ** 2).mean(dim=(1, 2, 3))

    def mse_j(x, y):
        return jnp.mean((x - y) ** 2, axis=(1, 2, 3))

    got = image.best_of_n_metric(mse_t, t(samples), t(target))
    ref = jimage.best_of_n_metric(mse_j, jnp.asarray(samples), jnp.asarray(target))
    for g, r in zip(got, ref):
        assert _err(g, r) <= IMG_TOL
    assert float(got[1].max()) > 0


# ---------------------------------------------------------------------------
# VGG16, LPIPS, diversity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames32():
    x = _videos(2, (3, 32, 32, 3))
    y = np.clip(x + 0.3 * np.random.default_rng(3).standard_normal(x.shape), -1, 1)
    return x, y.astype(np.float32)


def test_vgg16_filters_and_taps_match_jax(frames32):
    x, _ = frames32
    jparams, jpre = jvgg._cached("vgg16_features")
    net = vgg.vgg16()
    assert net.pretrained == jpre
    for idx, p in jparams.items():
        assert np.array_equal(net.host[idx]["w"], p["w"]) and np.array_equal(net.host[idx]["b"], p["b"])
    xin = jvgg.normalize_m11_to_imagenet(jnp.asarray(x))
    assert _err(vgg.normalize_m11_to_imagenet(t(x)), xin) <= 1e-7
    ref = jvgg.features(jparams, xin, jvgg.VGG16_LAYOUT, jvgg.VGG16_LPIPS_TAPS)
    got = net.features(t(np.asarray(xin)))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert _err(g, r) <= NET_TOL


def test_vgg16_diversity_features_match_jax(frames32, monkeypatch):
    x, _ = frames32
    ref = jvgg.vgg16_diversity_features(jnp.asarray(x))
    assert _err(vgg.vgg16_diversity_features(t(x)), ref) <= NET_TOL
    monkeypatch.setattr(vgg, "FRAME_CHUNK", 2)     # passes of 2 frames give the same features
    assert _err(vgg.vgg16_diversity_features(t(x)), ref) <= NET_TOL


@pytest.mark.parametrize("fn", ["lpips", "lpips_video"])
def test_lpips_matches_jax(frames32, fn, monkeypatch):
    x, y = frames32
    if fn == "lpips_video":
        x, y = x[None], y[None]
        monkeypatch.setattr(vgg, "FRAME_CHUNK", 2)
    ref = getattr(jlpips, fn)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(lpips, fn)(t(x), t(y))
    assert _err(got, ref) <= NET_TOL
    assert float(got.min()) > 0
    assert lpips.lpips_pretrained() == jlpips.lpips_pretrained() is False


@pytest.fixture(scope="module")
def div_samples():
    """(n_ex 3, n_samples 3, T 1, 32, 32, 3): three pairs per example, each
    pair's LPIPS on frames of the shape of ``frames32``."""
    return _videos(4, (3, 3, 1, 32, 32, 3))


@pytest.mark.parametrize("score", ["vgg", "mse", "lpips"])
def test_diversity_scores_match_jax(div_samples, score):
    got = getattr(diversity, f"div_score_{score}")(t(div_samples))
    ref = getattr(jdiv, f"div_score_{score}")(jnp.asarray(div_samples))
    assert isinstance(got, float) and got > 0
    assert abs(got - ref) <= NET_TOL * (1 + abs(ref))


# ---------------------------------------------------------------------------
# I3D
# ---------------------------------------------------------------------------

def _ncdhw(x):
    return t(np.asarray(x)).permute(0, 4, 1, 2, 3)


def _unit_params(rng, k, ci, co):
    w = (rng.standard_normal(k + (ci, co)) / np.sqrt(np.prod(k) * ci)).astype(np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return {"w": w, "b": b}


def test_i3d_filters_are_jax_draw():
    host, pre = i3d.load_params()
    jhost, jpre = ji3d.load_params()
    assert pre == jpre is False and list(host) == list(jhost) == [n for n, *_ in i3d._unit_names()]
    for name in ("Conv3d_1a_7x7", "Mixed_4f/b1b", "logits"):
        assert np.array_equal(host[name]["w"], jhost[name]["w"]), name
    up = i3d.upload({"logits": jhost["logits"]}, "cpu")["logits"]["w"]
    assert tuple(up.shape) == (400, 1024, 1, 1, 1)


@pytest.mark.parametrize("k,stride,shape,padding,relu", [
    ((7, 7, 7), 2, (1, 5, 13, 11, 3), "SAME", True),    # the stem: odd sizes, asymmetric pads
    ((3, 3, 3), 1, (2, 3, 6, 5, 4), "SAME", True),
    ((1, 1, 1), 1, (1, 2, 4, 4, 6), "VALID", False),     # the logits
])
def test_i3d_unit_matches_jax(k, stride, shape, padding, relu):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    p = _unit_params(rng, k, shape[-1], 8)
    ref = ji3d._unit({kk: jnp.asarray(v) for kk, v in p.items()}, jnp.asarray(x), stride=stride,
                     padding=padding, relu=relu)
    got = i3d._unit(i3d.upload({"u": p}, "cpu")["u"], _ncdhw(x), stride=stride, padding=padding,
                    relu=relu)
    assert _err(got.permute(0, 2, 3, 4, 1), ref) <= NET_TOL


@pytest.mark.parametrize("window,strides", [
    ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2))])
def test_i3d_maxpool_matches_jax(window, strides):
    """Odd sizes pad asymmetrically; all-negative inputs show a zero pad."""
    x = -np.abs(np.random.default_rng(6).standard_normal((1, 5, 7, 9, 2))).astype(np.float32) - 1
    ref = ji3d._maxpool(jnp.asarray(x), window, strides)
    got = i3d._maxpool(_ncdhw(x), window, strides).permute(0, 2, 3, 4, 1)
    assert _err(got, ref) == 0.0


def test_i3d_inception_matches_jax():
    host, _ = i3d.load_params()
    names = [n for n in host if n.startswith("Mixed_3b/")]
    x = np.abs(np.random.default_rng(7).standard_normal((1, 3, 5, 4, 192))).astype(np.float32)
    ref = ji3d._inception({n: {k: jnp.asarray(v) for k, v in host[n].items()} for n in names},
                          "Mixed_3b", jnp.asarray(x))
    got = i3d._inception(i3d.upload({n: host[n] for n in names}, "cpu"), "Mixed_3b", _ncdhw(x))
    assert got.shape[1] == 256
    assert _err(got.permute(0, 2, 3, 4, 1), ref) <= NET_TOL


@pytest.fixture(scope="module")
def i3d_videos():
    """One video of 3 frames of 40x40 (resized to 224x224 by both) and JAX's features."""
    v = _videos(8, (1, 3, 40, 40, 3))
    params = jax.tree_util.tree_map(jnp.asarray, ji3d.load_params()[0])
    return v, np.asarray(jax.jit(ji3d.features)(jnp.asarray(v), params))


def test_i3d_features_match_jax(i3d_videos):
    v, ref = i3d_videos
    got = i3d.features(t(v))
    assert got.shape == (1, 400)
    assert _err(got, ref) <= NET_TOL
    assert fvd.compute_features(v, batch_size=1, device="cpu")[0].shape == (1, 400)


# ---------------------------------------------------------------------------
# Frechet distance, moments, the accumulator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feats():
    """12 feature rows of 16 dims (the code is the same for I3D's 400; a
    400x400 ``sqrtm`` takes seconds here)."""
    rng = np.random.default_rng(9)
    real = rng.standard_normal((12, 16)).astype(np.float32)
    fake = (0.5 + 1.2 * rng.standard_normal((12, 16))).astype(np.float32)
    return real, fake


def test_moments_and_frechet_distance_match_jax(feats):
    real, fake = feats
    m_r, s_r = fvd._moments(real)
    jm_r, js_r = jfvd._moments(real)
    assert _err(m_r, jm_r) <= F64_TOL and _err(s_r, js_r) <= F64_TOL
    got = fvd.frechet_distance(m_r, s_r, *fvd._moments(fake))
    ref = jfvd.frechet_distance(jm_r, js_r, *jfvd._moments(fake))
    assert got > 0 and abs(got - ref) <= F64_TOL * (1 + abs(ref))
    nan_rows = real.copy()
    nan_rows[1:, 0] = np.nan
    for mod in (fvd, jfvd):
        with pytest.raises(ValueError, match="only 1/12 finite feature rows"):
            mod._moments(nan_rows)


def test_fvd_accumulator_matches_jax(feats, monkeypatch):
    """The accumulator's bookkeeping on given features: the n_samples cap in
    update and compute, the NaN-row filter and its counts; ``compute_fvd``'s
    batches."""
    real, fake = feats
    fake = fake.copy()
    fake[3, 7] = np.nan
    batches = [(real[i:i + 4], fake[i:i + 4]) for i in (0, 4, 8)]
    monkeypatch.setattr(fvd, "_features", lambda v: v.numpy())
    port = fvd.FVDAccumulator(n_samples=6, device="cpu")
    jacc = jfvd.FVDAccumulator(n_samples=6)
    jacc._feat_fn = lambda v: np.asarray(v)
    for r, f in batches:
        port.update(r, f)
        jacc.update(r, f)
    assert len(port._real) == len(jacc._real) == 2       # the third batch is past the cap
    got, ref = port.compute(), jacc.compute()
    assert abs(got - ref) <= F64_TOL * (1 + abs(ref))
    assert (port.n_dropped_real, port.n_dropped_fake) == (jacc.n_dropped_real, jacc.n_dropped_fake) == (0, 1)
    assert port.pretrained == jacc.pretrained is False
    want = jfvd.frechet_distance(*jfvd._moments(real), *jfvd._moments(feats[1]))
    assert abs(fvd.compute_fvd(real, feats[1], batch_size=5, device="cpu") - want) <= F64_TOL * want
    port.reset()
    assert port._real == [] == port._fake


# ---------------------------------------------------------------------------
# weights from $IPOKE_WEIGHTS
# ---------------------------------------------------------------------------

@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    """Random I3D, VGG16 and LPIPS-head files in the JAX package's layouts
    under $IPOKE_WEIGHTS; every cache of both packages cleared around it."""
    rng = np.random.default_rng(10)
    i3d_npz = {}
    for name, ci, co, k in i3d._unit_names():
        key = name.replace("/", ".")
        i3d_npz[f"{key}.w"] = rng.standard_normal(k + (ci, co)).astype(np.float32) * 0.01
        i3d_npz[f"{key}.b"] = rng.standard_normal(co).astype(np.float32)
    np.savez(tmp_path / "i3d_kinetics_rgb.npz", **i3d_npz)
    vgg_npz = {}
    for item in vgg.VGG16_LAYOUT:
        if item != "M":
            idx, ci, co = item
            vgg_npz[f"conv{idx}/w"] = rng.standard_normal((co, ci, 3, 3)).astype(np.float32) * 0.05
            vgg_npz[f"conv{idx}/b"] = rng.standard_normal(co).astype(np.float32) * 0.01
    np.savez(tmp_path / "vgg16_features.npz", **vgg_npz)
    np.savez(tmp_path / "lpips_vgg_lins.npz",
             **{f"lin{i}/w": rng.uniform(0, 1, c).astype(np.float32)
                for i, c in enumerate(lpips._LIN_CHANNELS)})
    caches = (i3d.load_params, i3d.i3d, vgg.vgg16, lpips._lins, ji3d.load_params, jvgg._cached,
              jlpips._lins)

    def clear():
        for c in caches:
            c.cache_clear()

    clear()
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path))
    yield tmp_path
    monkeypatch.delenv("IPOKE_WEIGHTS")
    clear()


def test_weights_load_as_jax(weights_dir, frames32):
    host, pre = i3d.load_params()
    jhost, jpre = ji3d.load_params()
    assert pre and jpre and i3d.i3d().pretrained
    for name in jhost:
        assert np.array_equal(host[name]["w"], jhost[name]["w"]) and np.array_equal(host[name]["b"], jhost[name]["b"])
    jparams, jvpre = jvgg._cached("vgg16_features")
    assert vgg.vgg16().pretrained and jvpre
    for idx, p in jparams.items():
        assert np.array_equal(vgg.vgg16().host[idx]["w"], p["w"])
    assert lpips.lpips_pretrained() and jlpips.lpips_pretrained()
    x, y = frames32
    assert _err(lpips.lpips(t(x), t(y)), jlpips.lpips(jnp.asarray(x), jnp.asarray(y))) <= NET_TOL
    assert os.environ["IPOKE_WEIGHTS"] == str(weights_dir)
