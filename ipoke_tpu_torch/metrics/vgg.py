"""VGG-19 features and the perceptual (VGG) loss of first-stage training
(counterpart of ``ipoke_tpu/metrics/vgg.py``; the reference's VGGLoss).

Pretrained filters are read from ``$IPOKE_WEIGHTS/vgg19_features.npz`` (else
``logs/weights/``) as the JAX package reads them: torchvision ``features``
conv weights as ``conv{idx}/w`` (OIHW) and ``conv{idx}/b``.  Without the
file the extractor runs with the JAX package's seeded filters: the same numpy
draw (``default_rng(0)``, HWIO, scale ``sqrt(2 / (9 c_in))``), kept here as
the port's own copy, so both packages hold identical filters.  Those are fine
for tests and timing, not for reference-parity loss values.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn.core import conv2d

# torchvision ``features`` layout: (conv_idx, in, out), 'M' = maxpool
VGG19_LAYOUT = [
    (0, 3, 64), (2, 64, 64), "M",
    (5, 64, 128), (7, 128, 128), "M",
    (10, 128, 256), (12, 256, 256), (14, 256, 256), (16, 256, 256), "M",
    (19, 256, 512), (21, 512, 512), (23, 512, 512), (25, 512, 512), "M",
    (28, 512, 512), (30, 512, 512), (32, 512, 512), (34, 512, 512), "M",
]
# relu indices (torchvision numbering) after which the reference taps its slices
VGG19_SLICE_TAPS = (1, 6, 11, 20, 29)


def _weights_dir():
    return os.environ.get("IPOKE_WEIGHTS", os.path.join("logs", "weights"))


def load_or_init(name, layout, seed=0):
    """({conv_idx: {'w': HWIO, 'b': (O,)}} as numpy, pretrained?)."""
    path = os.path.join(_weights_dir(), f"{name}.npz")
    params = {}
    if os.path.exists(path):
        data = np.load(path)
        for item in layout:
            if item == "M":
                continue
            idx, _, _ = item
            params[idx] = {"w": np.ascontiguousarray(np.transpose(data[f"conv{idx}/w"], (2, 3, 1, 0))),
                           "b": np.asarray(data[f"conv{idx}/b"])}
        return params, True
    rng = np.random.default_rng(seed)
    for item in layout:
        if item == "M":
            continue
        idx, c_in, c_out = item
        w = rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32) * np.sqrt(2.0 / (9 * c_in))
        params[idx] = {"w": w, "b": np.zeros((c_out,), np.float32)}
    return params, False


def features(params, x, layout, taps):
    """x: (B,H,W,3) -> the feature maps after the ReLU at each tap index;
    ``params``: {conv_idx: {'w': OIHW, 'b'}} tensors.  Stops at the last tap."""
    feats = []
    cur = x
    for item in layout:
        if item == "M":
            cur = F.max_pool2d(cur.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            continue
        conv_idx, _, _ = item
        cur = F.relu(conv2d(cur, params[conv_idx]["w"], params[conv_idx]["b"], padding=1))
        if conv_idx + 1 in taps:
            feats.append(cur)
            if len(feats) == len(taps):
                break
    return feats


class VGG19:
    """The VGG19 filters of the perceptual loss, uploaded once per device
    (OIHW, f32) and kept for the life of the object."""

    def __init__(self):
        self.host, self.pretrained = load_or_init("vgg19_features", VGG19_LAYOUT)
        self._on = {}

    def params(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {
                idx: {"w": torch.from_numpy(np.ascontiguousarray(p["w"].transpose(3, 2, 0, 1))).to(device),
                      "b": torch.from_numpy(np.asarray(p["b"], np.float32)).to(device)}
                for idx, p in self.host.items()}
        return self._on[device]

    def features(self, x):
        return features(self.params(x.device), x, VGG19_LAYOUT, VGG19_SLICE_TAPS)


def vgg_loss(vgg: VGG19, x, y):
    """Perceptual L1 loss over the five VGG19 slices (the reference's
    VGGLoss): the mean over slices of each slice's mean |f(x) - f(y)|.
    x, y in [-1, 1], (B,H,W,3); like the reference, the inputs are not
    imagenet-normalised."""
    fx, fy = vgg.features(x), vgg.features(y)
    return sum(torch.mean((a - b).abs()) for a, b in zip(fx, fy)) / len(fx)
