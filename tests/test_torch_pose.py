"""The port's pose net (``metrics/pose``) against the JAX package's on the
CPU: the seeded filters bitwise, each kind of layer against JAX eager within
POSE_TOL * (1 + max|ref|), the peak picking and the KPS protocol exactly.
The whole depth-50 net (``heatmaps``, ``keypoints_rel``) is ``slow``: ~0.3 s
per 256² frame on one CPU thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.metrics import pose as jpose
from ipoke_tpu.nn.core import conv2d as jconv2d
from ipoke_tpu.nn.core import conv_transpose2d as jconv_transpose2d
from ipoke_tpu_torch.metrics import pose

POSE_TOL = 1e-5


def _close(got, ref, tol=POSE_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max() / (1 + np.abs(ref).max()))
    assert err <= tol, err
    return err


@pytest.fixture(scope="module")
def nets():
    """(JAX's numpy filters, the port's on the CPU)."""
    return jpose.load_params(), pose.pose_net().params("cpu")


def test_load_params_equals_jax_bitwise(nets):
    host, _ = nets
    got = pose.load_params()
    # the stem, 3 convs in each of 16 bottlenecks and 4 projections, 3 deconvs, the head
    assert list(got) == list(host) and len(got) == 1 + 3 * 16 + 4 + 3 + 1
    for k, v in host.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert not pose.pose_weights_available() and pose.default_depth() == 50


@pytest.mark.parametrize("prefix,cin,size,stride", [
    ("layer1.0", 64, 8, 1),      # projection shortcut at stride 1
    ("layer2.0", 256, 9, 2),     # strided, odd size
    ("layer3.2", 1024, 4, 1),    # identity shortcut
])
def test_bottleneck_matches_jax(nets, prefix, cin, size, stride):
    host, port = nets
    x = np.random.default_rng(1).standard_normal((2, size, size, cin)).astype(np.float32)
    ref = jpose._bottleneck({k: jnp.asarray(v) for k, v in host.items() if k.startswith(prefix)},
                            prefix, jnp.asarray(x), stride=stride)
    got = pose._bottleneck(port, prefix, torch.from_numpy(x), stride=stride)
    _close(got, ref)


def test_deconv_head_matches_jax(nets):
    """Three transpose convs (k=4, s=2, p=1, output_padding=0: 3x3 -> 24x24)
    and the 1x1 head."""
    host, port = nets
    x = np.random.default_rng(2).standard_normal((1, 3, 3, 2048)).astype(np.float32)
    y = jnp.asarray(x)
    for di in range(3):
        y = jax.nn.relu(jconv_transpose2d(y, jnp.asarray(host[f"deconv{di}.w"]), stride=2,
                                          padding=1, output_padding=0))
    ref = jconv2d(y, jnp.asarray(host["head.w"]))
    got = pose._deconv_head(port, torch.from_numpy(x))
    assert tuple(got.shape) == (1, 24, 24, 17)
    _close(got, ref)


@pytest.mark.parametrize("size", [37, 64, 128, 300, 512], ids=lambda s: f"{s}_to_256")
def test_resize_matches_jax_linear(size):
    """Up (half-pixel bilinear) and down (JAX antialiases when it shrinks)."""
    x = np.random.default_rng(size).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 256, 256, 3), method="linear")
    _close(pose.resize_linear(torch.from_numpy(x), 256), ref)


@pytest.mark.parametrize("shape", [(1, 9, 9, 4), (2, 10, 7, 3), (1, 128, 128, 2)])
def test_max_pool_matches_jax_reduce_window(shape):
    """-inf padding: a border of negative values keeps its own maximum."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32) - 2.0
    ref = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                ((0, 0), (1, 1), (1, 1), (0, 0)))
    got = pose.max_pool_3x3_s2(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_get_max_preds_matches_jax_exactly():
    """Ties (the first maximum wins), a channel that is never positive (-1),
    and a non-square map."""
    rng = np.random.default_rng(4)
    hm = rng.standard_normal((3, 6, 5, 4)).astype(np.float32)
    hm[0, :, :, 0] = 0.5                    # all tied
    hm[1, 2, 3, 1] = hm[1, 4, 0, 1] = 9.0   # two tied peaks
    hm[2, :, :, 2] = -np.abs(hm[2, :, :, 2])
    coords, conf = pose.get_max_preds(torch.from_numpy(hm))
    rc, rconf = jpose.get_max_preds(jnp.asarray(hm))
    assert np.array_equal(coords.numpy(), np.asarray(rc))
    assert np.array_equal(conf.numpy(), np.asarray(rconf))
    assert coords[2, 2].tolist() == [-1.0, -1.0] and coords[1, 1].tolist() == [3.0, 2.0]


@pytest.mark.parametrize("n", [1, 3])
def test_kps_nn_protocol_matches_jax_exactly(n):
    rng = np.random.default_rng(5 + n)
    pred = rng.uniform(0, 1, (4, n, 3, 17, 2)).astype(np.float32)
    tgt = rng.uniform(0, 1, (4, 1, 3, 17, 2)).astype(np.float32)
    got, ref = pose.kps_nn_protocol(pred, tgt), jpose.kps_nn_protocol(pred, tgt)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.slow
def test_heatmaps_and_keypoints_match_jax_at_depth_50():
    """The whole net on 3 frames of 64² (resized to 256²): heatmaps within
    POSE_TOL; keypoints equal where the heatmap's first peak leads the
    second by more than the tolerance (seeded filters give flat maps, so a
    peak may differ by an ulp); how many were compared is printed."""
    x = np.random.default_rng(6).uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jpose.heatmaps(jnp.asarray(x)))
    with torch.backends.mkldnn.flags(enabled=False):
        got = pose.heatmaps(torch.from_numpy(x)).numpy()
        kp = pose.keypoints_rel(torch.from_numpy(x))[0].numpy()
    assert got.shape == ref.shape == (3, 64, 64, 17)
    err = _close(got, ref)
    rkp = np.asarray(jpose.keypoints_rel(jnp.asarray(x))[0])
    flat = np.sort(ref.reshape(3, -1, 17), axis=1)
    clear = (flat[:, -1] - flat[:, -2]) > POSE_TOL * (1 + np.abs(ref).max())
    assert np.array_equal(kp[clear], rkp[clear])
    print(f"heatmaps err {err:.3g}; keypoints compared {int(clear.sum())} of {clear.size}")
