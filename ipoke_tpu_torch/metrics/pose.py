"""Pose estimation for the keypoint metrics (counterpart of
``ipoke_tpu/metrics/pose.py``; the reference's utils/posenet_wrapper.py
PoseNetWrapper around pose_resnet-152 and its get_max_preds).

pose_resnet is a ResNet backbone, three transpose convs and a 1x1 heatmap
head; here cuDNN convs through ``nn/core`` (NHWC at the interface, NCHW
views inside).

Weights: ``$IPOKE_WEIGHTS/pose_resnet_152.npz`` (else ``logs/weights/``),
HWIO kernels with the batch norm folded in, as the JAX package reads them.
Without the file both packages run the same seeded depth-50 filters (one
``np.random.default_rng(7)`` draw per conv, in ``load_params``'s order), so
the KPS protocol runs end to end; the callers then mark their scores
UNPRETRAINED.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn.core import conv2d, conv_transpose2d, from_hwio

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

BOTTLENECK_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
INPUT_SIZE = 256
_FALLBACK_DEPTH = 50   # the seeded stand-in backbone


def _weights_path():
    return os.path.join(os.environ.get("IPOKE_WEIGHTS", os.path.join("logs", "weights")),
                        "pose_resnet_152.npz")


def pose_weights_available():
    return os.path.exists(_weights_path())


def default_depth():
    return 152 if pose_weights_available() else _FALLBACK_DEPTH


@lru_cache(maxsize=1)
def load_params():
    """{name: HWIO numpy kernel}: the weights file's, else seeded He-init
    filters of a depth-50 pose_resnet (meaningless as poses)."""
    if pose_weights_available():
        data = np.load(_weights_path())
        return {k: np.asarray(v) for k, v in data.items()}
    rng = np.random.default_rng(7)

    def conv(ci, co, k):
        fan = k * k * ci
        return (rng.standard_normal((k, k, ci, co)) * np.sqrt(2.0 / fan)).astype(np.float32)

    p = {"stem.w": conv(3, 64, 7)}
    cin = 64
    widths = (64, 128, 256, 512)
    for li, n_blocks in enumerate(BOTTLENECK_LAYERS[_FALLBACK_DEPTH]):
        w = widths[li]
        for bi in range(n_blocks):
            pre = f"layer{li + 1}.{bi}"
            p[f"{pre}.conv1.w"] = conv(cin, w, 1)
            p[f"{pre}.conv2.w"] = conv(w, w, 3)
            p[f"{pre}.conv3.w"] = conv(w, w * 4, 1)
            if bi == 0:
                p[f"{pre}.down.w"] = conv(cin, w * 4, 1)
            cin = w * 4
    for di in range(3):
        p[f"deconv{di}.w"] = conv(cin, 256, 4)   # transpose-conv kernels, (k, k, in, out)
        cin = 256
    p["head.w"] = conv(256, 17, 1)
    return p


def upload(host, device):
    """``load_params``'s kernels as f32 tensors on ``device`` in the port's
    layouts: OIHW, the deconvs ``(in, out, kh, kw)``; biases as they are."""
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        if k.endswith(".w"):
            t = from_hwio(t, transposed=k.startswith("deconv"))
        out[k] = t.to(device)
    return out


class PoseNet:
    """The filters of ``load_params``, uploaded once per device."""

    def __init__(self):
        self.host = load_params()
        self._on = {}

    def params(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = upload(self.host, device)
        return self._on[device]


@lru_cache(maxsize=1)
def pose_net() -> PoseNet:
    """The process's one pose net."""
    return PoseNet()


def resize_linear(x, size):
    """NHWC ``x`` resized to ``size`` x ``size`` as ``jax.image.resize(...,
    "linear")``: half-pixel centres, a triangle kernel stretched when
    shrinking (antialiased), weights renormalised at the borders."""
    if tuple(x.shape[1:3]) == (size, size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def max_pool_3x3_s2(x):
    """NHWC max-pool, window 3, stride 2, padded by 1 with -inf (JAX's
    ``reduce_window`` with init -inf)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def _bottleneck(p, prefix, x, stride=1):
    def unit(name, y, s=1, pad=0):
        return conv2d(y, p[f"{prefix}.{name}.w"], p.get(f"{prefix}.{name}.b"), stride=s, padding=pad)

    out = F.relu(unit("conv1", x))
    out = F.relu(unit("conv2", out, s=stride, pad=1))
    out = unit("conv3", out)
    res = x
    if f"{prefix}.down.w" in p:
        res = conv2d(x, p[f"{prefix}.down.w"], p.get(f"{prefix}.down.b"), stride=stride)
    return F.relu(out + res)


def _deconv_head(p, x):
    """The three transpose convs (k=4, s=2, p=1, output_padding=0), each
    with a ReLU, then the 1x1 head."""
    for di in range(3):
        x = F.relu(conv_transpose2d(x, p[f"deconv{di}.w"], p.get(f"deconv{di}.b"),
                                    stride=2, padding=1, output_padding=0))
    return conv2d(x, p["head.w"], p.get("head.b"))


@torch.no_grad()
def heatmaps(images, depth=None):
    """images: (B, H, W, 3) in [-1, 1] -> (B, 64, 64, 17) COCO heatmaps: the
    frames resized to 256² (``resize_linear``) and ImageNet-normalised, as
    the reference's posenet_wrapper.py:24-37 feeds its net."""
    if depth is None:
        depth = default_depth()
    p = pose_net().params(images.device)
    x = resize_linear(images.float(), INPUT_SIZE)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    x = ((x + 1) * 0.5 - mean) / std
    x = F.relu(conv2d(x, p["stem.w"], p.get("stem.b"), stride=2, padding=3))
    x = max_pool_3x3_s2(x)
    for li, n_blocks in enumerate(BOTTLENECK_LAYERS[depth]):
        stride = 1 if li == 0 else 2
        for bi in range(n_blocks):
            x = _bottleneck(p, f"layer{li + 1}.{bi}", x, stride=stride if bi == 0 else 1)
    return _deconv_head(p, x)


def get_max_preds(hm):
    """Heatmap peaks (the reference's get_max_preds as a plain argmax, the
    first of equal maxima): hm (B, H, W, K) -> (coords (B, K, 2) as [x, y],
    -1 where the peak is not positive; confidences (B, K))."""
    b, h, w, k = hm.shape
    flat = hm.reshape(b, h * w, k)
    conf = flat.amax(dim=1)
    idx = flat.argmax(dim=1)
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    coords = torch.stack([xs, ys], dim=-1)
    return torch.where(conf[..., None] > 0, coords, torch.full_like(coords, -1.0)), conf


def keypoints_abs(images, input_size=None):
    """Keypoints in input pixels (the heatmap's scaled by input / heatmap size)."""
    hm = heatmaps(images)
    coords, conf = get_max_preds(hm)
    scale = (input_size or images.shape[1]) / hm.shape[1]
    return coords * scale, conf


def keypoints_rel(images):
    """Keypoints relative to the heatmap's size, and their confidences."""
    hm = heatmaps(images)
    coords, conf = get_max_preds(hm)
    return coords / hm.shape[1], conf


def kps_nn_protocol(kps_pred, kps_target):
    """The reference's KPSMetric.update (utils/metrics.py:285-307) in numpy.

    kps_pred: (B, N, T, K, 2) keypoints of N samples; kps_target: (B, 1, T,
    K, 2).  The nearest sample is chosen per example over its whole clip
    (argmin over N of the (T, K, 2)-mean squared error).  Returns numpy
    arrays: nn_err_per_frame (B, T), mean_per_frame (B, T), std_per_frame
    (B, T; the sample std, ddof=1, as torch's ``std``) and nn_err (B,)."""
    kps_pred = np.asarray(kps_pred, np.float32)
    kps_target = np.asarray(kps_target, np.float32)
    mse = (kps_pred - kps_target) ** 2                  # (B,N,T,K,2)
    mse_global = mse.mean(axis=(2, 3, 4))               # (B,N)
    min_ids = mse_global.argmin(axis=1)                 # (B,)
    mse_per_frame = mse.mean(axis=(3, 4))               # (B,N,T)
    b = mse.shape[0]
    nns_per_frame = mse_per_frame[np.arange(b), min_ids]  # (B,T)
    std_per_frame = (mse_per_frame.std(axis=1, ddof=1) if mse.shape[1] > 1
                     else np.zeros_like(nns_per_frame))
    return {
        "nn_err_per_frame": nns_per_frame,
        "mean_per_frame": mse_per_frame.mean(axis=1),
        "std_per_frame": std_per_frame,
        "nn_err": nns_per_frame.mean(axis=1),
    }


def video_keypoints_rel(videos):
    """(B, T, H, W, 3) videos -> (B, T, K, 2) numpy ``keypoints_rel`` of
    every frame, the B*T frames in one batch."""
    b, t = videos.shape[:2]
    kp = keypoints_rel(videos.reshape((b * t,) + tuple(videos.shape[2:])))[0]
    return kp.reshape(b, t, *kp.shape[1:]).cpu().numpy()


def keypoint_mse(params, spec, config, datamod, n_batches=8):
    """Best-of-N keypoint MSE in relative coordinates (the reference's
    KPSMetric, utils/metrics.py:259-331) over the first ``n_batches`` test
    batches: ``testing.n_samples_per_data_point`` samples per example on the
    keys of ``split`` from ``prng_key(0)``, the poke replaced by the batch's
    ``keypoint_poke`` where it has one."""
    from ipoke_tpu_torch.eval.test_modes import _to_batch, params_device
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.utils import prng

    tcfg = config.get("testing", {})
    n_samples = int(tcfg.get("n_samples_per_data_point", 5))
    device = params_device(params)
    rng = prng.prng_key(0)
    nn_errs, nn_frames = [], []
    for bi, raw in enumerate(datamod.loader("test")):
        if bi >= n_batches:
            break
        batch = _to_batch(raw, device)
        if "keypoint_poke" in raw:
            batch["poke"] = torch.from_numpy(np.asarray(raw["keypoint_poke"])).to(device)
        rng, sub = prng.split(rng)
        vids = second_stage.forward_sample(params, spec, batch, sub, n_samples=n_samples)
        tgt = batch["images"][:, 1:]
        kp_gt = video_keypoints_rel(tgt)[:, None]                                   # (B,1,T,K,2)
        kp_pred = np.stack([video_keypoints_rel(v) for v in vids], axis=1)        # (B,N,T,K,2)
        stats = kps_nn_protocol(kp_pred, kp_gt)
        nn_errs.append(stats["nn_err"])
        nn_frames.append(stats["nn_err_per_frame"])
    key = "KPS_mse" if pose_weights_available() else "KPS_mse_UNPRETRAINED"
    return {
        key: float(np.concatenate(nn_errs).mean()),
        f"{key}_per_frame": np.concatenate(nn_frames).mean(0).tolist(),
        "pose_pretrained": pose_weights_available(),
    }
