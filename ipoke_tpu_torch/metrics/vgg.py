"""VGG-19/16 features: the perceptual (VGG) loss of first-stage training,
the LPIPS backbone and the VGG-cosine diversity score (counterpart of
``ipoke_tpu/metrics/vgg.py``; the reference's VGGLoss, LPIPS and
utils/metrics.py:20-58).

Pretrained filters are read from ``$IPOKE_WEIGHTS/<name>.npz`` (else
``logs/weights/``; ``vgg19_features`` / ``vgg16_features``) as the JAX
package reads them: torchvision ``features`` conv weights as ``conv{idx}/w``
(OIHW) and ``conv{idx}/b``.  Without the file the extractor runs with the JAX
package's seeded filters: the same numpy draw (``default_rng(0)``, HWIO,
scale ``sqrt(2 / (9 c_in))``, in the network's own layout), kept here as the
port's own copy, so both packages hold identical filters.  Those are fine
for tests, timing and relative diversity scores, not for reference-parity
loss or LPIPS values.
"""
from __future__ import annotations

import os
from functools import lru_cache

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
VGG16_LAYOUT = [
    (0, 3, 64), (2, 64, 64), "M",
    (5, 64, 128), (7, 128, 128), "M",
    (10, 128, 256), (12, 256, 256), (14, 256, 256), "M",
    (17, 256, 512), (19, 512, 512), (21, 512, 512), "M",
    (24, 512, 512), (26, 512, 512), (28, 512, 512), "M",
]
# relu indices (torchvision numbering) after which the reference taps its slices
VGG19_SLICE_TAPS = (1, 6, 11, 20, 29)
VGG16_LPIPS_TAPS = (3, 8, 15, 22, 29)      # relu1_2 .. relu5_3

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# frames per VGG16 pass of the diversity features and LPIPS: bounds the
# activations' memory on long sample sets; every op is per frame
FRAME_CHUNK = 256


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


class VGG:
    """A VGG's filters, uploaded once per device (OIHW, f32) and kept for
    the life of the object; ``features`` taps the network's slices."""

    name, layout, taps = None, None, None

    def __init__(self):
        self.host, self.pretrained = load_or_init(self.name, self.layout)
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
        return features(self.params(x.device), x, self.layout, self.taps)


class VGG19(VGG):
    """The perceptual loss's VGG19, tapped at relu1_1 .. relu5_1."""

    name, layout, taps = "vgg19_features", VGG19_LAYOUT, VGG19_SLICE_TAPS


class VGG16(VGG):
    """LPIPS's and the diversity score's VGG16, tapped at relu1_2 .. relu5_3."""

    name, layout, taps = "vgg16_features", VGG16_LAYOUT, VGG16_LPIPS_TAPS


@lru_cache(maxsize=1)
def vgg16() -> VGG16:
    """The process's one VGG16 (JAX's ``_cached("vgg16_features")``)."""
    return VGG16()


def normalize_m11_to_imagenet(x):
    """[-1, 1] RGB (..., 3) -> imagenet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return ((x + 1.0) * 0.5 - mean) / std


def vgg_loss(vgg: VGG19, x, y):
    """Perceptual L1 loss over the five VGG19 slices (the reference's
    VGGLoss): the mean over slices of each slice's mean |f(x) - f(y)|.
    x, y in [-1, 1], (B,H,W,3); like the reference, the inputs are not
    imagenet-normalised."""
    fx, fy = vgg.features(x), vgg.features(y)
    return sum(torch.mean((a - b).abs()) for a, b in zip(fx, fy)) / len(fx)


def vgg16_diversity_features(x):
    """(N, H, W, 3) in [-1, 1] -> (N, 1472): each VGG16 slice's spatial mean,
    concatenated and unit-normalised (the diversity score's cosine
    features), FRAME_CHUNK frames per pass."""
    net = vgg16()
    out = []
    for i in range(0, x.shape[0], FRAME_CHUNK):
        feats = net.features(normalize_m11_to_imagenet(x[i:i + FRAME_CHUNK]))
        out.append(torch.cat([f.mean(dim=(1, 2)) for f in feats], dim=-1))
    cat = torch.cat(out)
    return cat / (torch.linalg.vector_norm(cat, dim=-1, keepdim=True) + 1e-8)
