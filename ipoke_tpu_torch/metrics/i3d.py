"""I3D (Inflated Inception-V1, Kinetics-400) for FVD features (counterpart
of ``ipoke_tpu/metrics/i3d.py``; the reference's PyTorch I3D of
utils/metrics.py:999-1105 and the tfhub graph of its official numbers are
this architecture).

Weights are read from ``$IPOKE_WEIGHTS/i3d_kinetics_rgb.npz`` (else
``logs/weights/``) as the JAX package reads them: DHWIO kernels with the
batch norm folded into ``w`` and ``b``, keys ``<unit>.w`` / ``<unit>.b``.
Without the file the network runs with the JAX package's seeded filters: one
``np.random.default_rng(0)`` draw per unit in ``_unit_names()`` order,
``standard_normal(k + (ci, co)) * sqrt(2 / fan_in)`` in DHWIO, kept here as
the port's own copy, so both packages hold identical filters.  Those give
relative FVD comparisons only, never reference-parity scores.

``features`` takes (B, T, H, W, 3) videos; inside, the network runs on
NCDHW (the private ``_unit``, ``_maxpool`` and ``_inception`` take and give
NCDHW), with TF's asymmetric "SAME" padding written out by ``F.pad``.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn.core import resize_bilinear_align_corners

# GoogLeNet inception channel table:
# name -> (out1x1, red3x3, out3x3, red5x5 (a 3x3 in i3d), out5x5, pool_proj)
INCEPTION = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}

MIXED_IN = {
    "Mixed_3b": 192, "Mixed_3c": 256,
    "Mixed_4b": 480, "Mixed_4c": 512, "Mixed_4d": 512, "Mixed_4e": 512, "Mixed_4f": 528,
    "Mixed_5b": 832, "Mixed_5c": 832,
}

INPUT_SIZE = 224


def _unit_names():
    """[(name, c_in, c_out, kernel DHW)] in the order of the seeded draw."""
    names = [("Conv3d_1a_7x7", 3, 64, (7, 7, 7)), ("Conv3d_2b_1x1", 64, 64, (1, 1, 1)),
             ("Conv3d_2c_3x3", 64, 192, (3, 3, 3))]
    for blk, (o1, r3, o3, r5, o5, pp) in INCEPTION.items():
        cin = MIXED_IN[blk]
        names += [
            (f"{blk}/b0", cin, o1, (1, 1, 1)),
            (f"{blk}/b1a", cin, r3, (1, 1, 1)),
            (f"{blk}/b1b", r3, o3, (3, 3, 3)),
            (f"{blk}/b2a", cin, r5, (1, 1, 1)),
            (f"{blk}/b2b", r5, o5, (3, 3, 3)),
            (f"{blk}/b3", cin, pp, (1, 1, 1)),
        ]
    names.append(("logits", 1024, 400, (1, 1, 1)))
    return names


def _weights_path():
    d = os.environ.get("IPOKE_WEIGHTS", os.path.join("logs", "weights"))
    return os.path.join(d, "i3d_kinetics_rgb.npz")


@lru_cache(maxsize=1)
def load_params():
    """({name: {'w': DHWIO, 'b': (O,)}} as numpy, pretrained?)."""
    path = _weights_path()
    params = {}
    if os.path.exists(path):
        data = np.load(path)
        for name, _, _, _ in _unit_names():
            key = name.replace("/", ".")
            params[name] = {"w": np.asarray(data[f"{key}.w"]), "b": np.asarray(data[f"{key}.b"])}
        return params, True
    rng = np.random.default_rng(0)
    for name, ci, co, k in _unit_names():
        fan_in = ci * k[0] * k[1] * k[2]
        params[name] = {
            "w": (rng.standard_normal(k + (ci, co)) * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": np.zeros((co,), np.float32),
        }
    return params, False


def upload(host, device):
    """numpy DHWIO params -> {name: {'w': OIDHW, 'b'}} f32 tensors on ``device``."""
    return {name: {"w": torch.from_numpy(np.ascontiguousarray(
                       np.asarray(p["w"], np.float32).transpose(4, 3, 0, 1, 2))).to(device),
                   "b": torch.from_numpy(np.asarray(p["b"], np.float32)).to(device)}
            for name, p in host.items()}


class I3D:
    """The I3D filters of ``load_params``, uploaded once per device."""

    def __init__(self):
        self.host, self.pretrained = load_params()
        self._on = {}

    def params(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = upload(self.host, device)
        return self._on[device]


@lru_cache(maxsize=1)
def i3d() -> I3D:
    """The process's one I3D."""
    return I3D()


def _tf_same_pads(in_sizes, window, strides):
    """TF "SAME" padding: for size n, kernel k, stride s the total pad is
    max((ceil(n/s) - 1) s + k - n, 0), the smaller half first."""
    pads = []
    for n, k, s in zip(in_sizes, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _f_pad(pads):
    """((d0, d1), (h0, h1), (w0, w1)) -> F.pad's last-axis-first order."""
    (d0, d1), (h0, h1), (w0, w1) = pads
    return (w0, w1, h0, h1, d0, d1)


def _unit(p, x, stride=1, padding="SAME", relu=True):
    """Conv3d (+ folded BN bias) and ReLU on NCDHW; ``p['w']`` OIDHW."""
    if isinstance(stride, int):
        stride = (stride, stride, stride)
    if padding == "SAME":
        x = F.pad(x, _f_pad(_tf_same_pads(x.shape[2:5], p["w"].shape[2:5], stride)))
    y = F.conv3d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride)
    return F.relu(y) if relu else y


def _maxpool(x, window, strides):
    """Max pool with TF "SAME" padding on NCDHW; the pad is -inf, so it never wins."""
    x = F.pad(x, _f_pad(_tf_same_pads(x.shape[2:5], window, strides)), value=float("-inf"))
    return F.max_pool3d(x, window, strides)


def _inception(params, name, x):
    b0 = _unit(params[f"{name}/b0"], x)
    b1 = _unit(params[f"{name}/b1b"], _unit(params[f"{name}/b1a"], x))
    b2 = _unit(params[f"{name}/b2b"], _unit(params[f"{name}/b2a"], x))
    b3 = _unit(params[f"{name}/b3"], _maxpool(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


@torch.no_grad()
def features(video, params=None):
    """video: (B, T, H, W, 3) in [-1, 1] -> (B, 400) logits, the features of
    the reference's FVD (utils/metrics.py:726-733).  ``params``: uploaded
    (``upload``) on the video's device, else the process's I3D there.

    The reference's preprocessing: a bilinear align-corners resize to
    224x224, then [-1, 1] -> [0, 1]."""
    if params is None:
        params = i3d().params(video.device)
    b, t, h, w, c = video.shape
    if (h, w) != (INPUT_SIZE, INPUT_SIZE):
        video = resize_bilinear_align_corners(video.reshape(b * t, h, w, c),
                                              (INPUT_SIZE, INPUT_SIZE))
        video = video.reshape(b, t, INPUT_SIZE, INPUT_SIZE, c)
    x = ((video + 1.0) * 0.5).permute(0, 4, 1, 2, 3)         # NCDHW
    x = _unit(params["Conv3d_1a_7x7"], x, stride=2)
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _unit(params["Conv3d_2b_1x1"], x)
    x = _unit(params["Conv3d_2c_3x3"], x)
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _inception(params, "Mixed_3b", x)
    x = _inception(params, "Mixed_3c", x)
    x = _maxpool(x, (3, 3, 3), (2, 2, 2))
    for blk in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        x = _inception(params, blk, x)
    x = _maxpool(x, (2, 2, 2), (2, 2, 2))
    x = _inception(params, "Mixed_5b", x)
    x = _inception(params, "Mixed_5c", x)
    # the reference's head: AvgPool3d((2, H', W'), stride 1, VALID), the 1x1x1
    # logits conv, then the mean over the time steps left
    x = F.avg_pool3d(x, (min(2, x.shape[2]), x.shape[3], x.shape[4]), stride=1)
    x = _unit(params["logits"], x, padding="VALID", relu=False)
    return x.mean(dim=(2, 3, 4))
