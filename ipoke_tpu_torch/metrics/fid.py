"""FID for the image-encoder validation (counterpart of
``ipoke_tpu/metrics/fid.py``; the reference's utils/metrics.py:380-403 FID
metric and FIDInceptionModel :540-588 over InceptionV3 pool3 features).

InceptionV3 (the torchvision/FID variant), table-driven, NHWC at the
interface, cuDNN convs through ``nn/core``; the batch norm is folded in at
conversion (``ckpt/torch_import.convert_inception_v3``).  Weights:
``$IPOKE_WEIGHTS/inception_v3_fid.npz`` (else ``logs/weights/``); without
the file both packages run the same seeded filters (one
``np.random.default_rng(0)`` draw per unit in ``_all_units()`` order), for
relative comparisons only.

The reference's quirk (utils/metrics.py:575-588): FIDInceptionModel iterates
``self.v3._modules`` and injects ``F.avg_pool2d(k=3, s=2)`` after
Conv2d_2b_3x3 / Conv2d_4a_3x3.  In torchvision 0.8.x the stem max pools are
functional calls, not modules, so the injected avg pools replace them: the
standard stem geometry (149-147-147-73-73-71-35) with avg instead of max
downsampling.  Every avg pool divides by the whole window, padding included
(``count_include_pad``), as JAX's ``reduce_window`` sum does.
Preprocessing: JAX's linear resize to 299 (antialiased when it shrinks,
``metrics/pose.resize_linear``), [-1,1] -> [0,1], then ImageNet mean/std.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ipoke_tpu_torch.metrics.fvd import _on, frechet_distance
from ipoke_tpu_torch.metrics.pose import resize_linear
from ipoke_tpu_torch.nn.core import conv2d, from_hwio

INPUT_SIZE = 299


def _pool(x, window, stride, pad, kind="max"):
    """NHWC pooling as JAX's ``reduce_window``: max pads with -inf; avg sums
    with zero padding and divides by the whole window."""
    y = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(y, window, stride, padding=pad)
    else:
        y = F.avg_pool2d(y, window, stride, padding=pad, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


# unit table: name -> (kh, kw, c_in, c_out, stride, pad).  AVGPOOL entries are
# the reference's injected F.avg_pool2d calls, which replace torchvision
# 0.8.x's functional stem max pools (see the module docstring).
def _stem():
    return [
        ("Conv2d_1a_3x3", 3, 3, 3, 32, 2, 0),
        ("Conv2d_2a_3x3", 3, 3, 32, 32, 1, 0),
        ("Conv2d_2b_3x3", 3, 3, 32, 64, 1, 1),
        ("AVGPOOL", 3, 3, 0, 0, 2, 0),
        ("Conv2d_3b_1x1", 1, 1, 64, 80, 1, 0),
        ("Conv2d_4a_3x3", 3, 3, 80, 192, 1, 0),
        ("AVGPOOL", 3, 3, 0, 0, 2, 0),
    ]


def _inception_a(cin, pool_feat):
    return {
        "b1x1": [(1, 1, cin, 64, 1, 0)],
        "b5x5": [(1, 1, cin, 48, 1, 0), (5, 5, 48, 64, 1, 2)],
        "b3x3dbl": [(1, 1, cin, 64, 1, 0), (3, 3, 64, 96, 1, 1), (3, 3, 96, 96, 1, 1)],
        "bpool": [(1, 1, cin, pool_feat, 1, 0)],
    }


def _inception_b(cin):  # reduction
    return {
        "b3x3": [(3, 3, cin, 384, 2, 0)],
        "b3x3dbl": [(1, 1, cin, 64, 1, 0), (3, 3, 64, 96, 1, 1), (3, 3, 96, 96, 2, 0)],
    }


def _inception_c(cin, c7):
    return {
        "b1x1": [(1, 1, cin, 192, 1, 0)],
        "b7x7": [(1, 1, cin, c7, 1, 0), (1, 7, c7, c7, 1, (0, 3)), (7, 1, c7, 192, 1, (3, 0))],
        "b7x7dbl": [
            (1, 1, cin, c7, 1, 0), (7, 1, c7, c7, 1, (3, 0)), (1, 7, c7, c7, 1, (0, 3)),
            (7, 1, c7, c7, 1, (3, 0)), (1, 7, c7, 192, 1, (0, 3)),
        ],
        "bpool": [(1, 1, cin, 192, 1, 0)],
    }


def _inception_d(cin):  # reduction
    return {
        "b3x3": [(1, 1, cin, 192, 1, 0), (3, 3, 192, 320, 2, 0)],
        "b7x7x3": [
            (1, 1, cin, 192, 1, 0), (1, 7, 192, 192, 1, (0, 3)),
            (7, 1, 192, 192, 1, (3, 0)), (3, 3, 192, 192, 2, 0),
        ],
    }


def _inception_e(cin):
    return {
        "b1x1": [(1, 1, cin, 320, 1, 0)],
        "b3x3_1": [(1, 1, cin, 384, 1, 0)],
        "b3x3_2a": [(1, 3, 384, 384, 1, (0, 1))],
        "b3x3_2b": [(3, 1, 384, 384, 1, (1, 0))],
        "b3x3dbl_1": [(1, 1, cin, 448, 1, 0), (3, 3, 448, 384, 1, 1)],
        "b3x3dbl_2a": [(1, 3, 384, 384, 1, (0, 1))],
        "b3x3dbl_2b": [(3, 1, 384, 384, 1, (1, 0))],
        "bpool": [(1, 1, cin, 192, 1, 0)],
    }


BLOCKS = [
    ("Mixed_5b", "A", 192, 32), ("Mixed_5c", "A", 256, 64), ("Mixed_5d", "A", 288, 64),
    ("Mixed_6a", "B", 288, 0),
    ("Mixed_6b", "C", 768, 128), ("Mixed_6c", "C", 768, 160),
    ("Mixed_6d", "C", 768, 160), ("Mixed_6e", "C", 768, 192),
    ("Mixed_7a", "D", 768, 0), ("Mixed_7b", "E", 1280, 0), ("Mixed_7c", "E", 2048, 0),
]


def _block_table(kind, cin, extra):
    return {"A": lambda: _inception_a(cin, extra), "B": lambda: _inception_b(cin),
            "C": lambda: _inception_c(cin, extra), "D": lambda: _inception_d(cin),
            "E": lambda: _inception_e(cin)}[kind]()


def _all_units():
    units = [(name, kh, kw, ci, co) for name, kh, kw, ci, co, _, _ in _stem() if name != "AVGPOOL"]
    for bname, kind, cin, extra in BLOCKS:
        for branch, convs in _block_table(kind, cin, extra).items():
            for i, (kh, kw, ci, co, _, _) in enumerate(convs):
                units.append((f"{bname}.{branch}.{i}", kh, kw, ci, co))
    return units


def _weights_path():
    return os.path.join(os.environ.get("IPOKE_WEIGHTS", os.path.join("logs", "weights")),
                        "inception_v3_fid.npz")


@lru_cache(maxsize=1)
def load_params():
    """({unit: {'w': HWIO, 'b': (O,)}} as numpy, pretrained?)."""
    path, params = _weights_path(), {}
    if os.path.exists(path):
        data = np.load(path)
        for name, *_ in _all_units():
            params[name] = {"w": np.asarray(data[f"{name}.w"]), "b": np.asarray(data[f"{name}.b"])}
        return params, True
    rng = np.random.default_rng(0)
    for name, kh, kw, ci, co in _all_units():
        fan = kh * kw * ci
        params[name] = {
            "w": (rng.standard_normal((kh, kw, ci, co)) * np.sqrt(2.0 / fan)).astype(np.float32),
            "b": np.zeros((co,), np.float32),
        }
    return params, False


def upload(host, device):
    """numpy HWIO params -> {unit: {'w': OIHW, 'b'}} f32 tensors on ``device``."""
    return {name: {"w": from_hwio(torch.from_numpy(np.asarray(p["w"], np.float32))).to(device),
                   "b": torch.from_numpy(np.asarray(p["b"], np.float32)).to(device)}
            for name, p in host.items()}


class Inception:
    """The filters of ``load_params``, uploaded once per device."""

    def __init__(self):
        self.host, self.pretrained = load_params()
        self._on = {}

    def params(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = upload(self.host, device)
        return self._on[device]


@lru_cache(maxsize=1)
def inception() -> Inception:
    """The process's one InceptionV3."""
    return Inception()


def _unit(p, name, x, stride=1, pad=0):
    if isinstance(pad, int):
        pad = (pad, pad)
    return F.relu(conv2d(x, p[name]["w"], p[name]["b"], stride=stride,
                         padding=((pad[0], pad[0]), (pad[1], pad[1]))))


def _run_branch(p, prefix, convs, x):
    for i, cv in enumerate(convs):
        x = _unit(p, f"{prefix}.{i}", x, stride=cv[4], pad=cv[5])
    return x


def _block(p, bname, kind, cin, extra, x):
    """One Mixed block on NHWC ``x``."""
    spec = _block_table(kind, cin, extra)
    if kind in ("A", "C"):
        outs = [_run_branch(p, f"{bname}.{branch}", convs,
                            _pool(x, (3, 3), (1, 1), 1, "avg") if branch == "bpool" else x)
                for branch, convs in spec.items()]
    elif kind in ("B", "D"):
        outs = [_run_branch(p, f"{bname}.{branch}", convs, x) for branch, convs in spec.items()]
        outs.append(_pool(x, (3, 3), (2, 2), 0, "max"))
    else:  # E
        def pair(src, a, b):
            return torch.cat([_run_branch(p, f"{bname}.{a}", spec[a], src),
                              _run_branch(p, f"{bname}.{b}", spec[b], src)], -1)

        outs = [_run_branch(p, f"{bname}.b1x1", spec["b1x1"], x),
                pair(_run_branch(p, f"{bname}.b3x3_1", spec["b3x3_1"], x), "b3x3_2a", "b3x3_2b"),
                pair(_run_branch(p, f"{bname}.b3x3dbl_1", spec["b3x3dbl_1"], x),
                     "b3x3dbl_2a", "b3x3dbl_2b"),
                _run_branch(p, f"{bname}.bpool", spec["bpool"], _pool(x, (3, 3), (1, 1), 1, "avg"))]
    return torch.cat(outs, dim=-1)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pool3_features(images, params=None):
    """images: (B, H, W, 3) f32 tensor in [-1, 1] -> (B, 2048) pool3
    features, on the images' device (FIDInceptionModel's preprocessing,
    utils/metrics.py:566-575)."""
    p = params if params is not None else inception().params(images.device)
    x = resize_linear(images, INPUT_SIZE)
    x = (x + 1.0) * 0.5
    x = (x - torch.from_numpy(IMAGENET_MEAN).to(x.device)) / torch.from_numpy(IMAGENET_STD).to(x.device)
    for name, _, _, _, _, s, pad in _stem():
        if name == "AVGPOOL":
            x = _pool(x, (3, 3), (2, 2), 0, "avg")
        else:
            x = _unit(p, name, x, stride=s, pad=pad)
    for bname, kind, cin, extra in BLOCKS:
        x = _block(p, bname, kind, cin, extra, x)
    return x.mean(dim=(1, 2))


def compute_fid(real_images, fake_images, batch_size=32, device=None):
    """FID over two image sets (N, H, W, 3) in [-1, 1] (numpy or tensors),
    with the reference's NaN-row filter (utils/metrics.py:489-538).
    ``device``: where the features run (None: a tensor's own device, the
    card for numpy)."""
    def feats(imgs):
        with torch.no_grad():
            out = [pool3_features(_on(imgs[i:i + batch_size], device)).cpu().numpy()
                   for i in range(0, imgs.shape[0], batch_size)]
        f = np.concatenate(out)
        return f[np.isfinite(f).all(axis=1)]

    fr, ff = feats(real_images), feats(fake_images)
    return frechet_distance(fr.mean(0), np.cov(fr, rowvar=False),
                            ff.mean(0), np.cov(ff, rowvar=False))
