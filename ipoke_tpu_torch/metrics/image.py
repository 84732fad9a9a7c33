"""Image quality metrics: SSIM and PSNR (counterpart of
``ipoke_tpu/metrics/image.py``; the reference wraps pytorch-lightning's
functional ssim/psnr on [0, 1]-denormalised frames).

Inputs are [-1, 1] videos or frames, NHWC, on any device; they are
denormalised to [0, 1] as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _denorm(x):
    return ((x + 1.0) * 0.5).clamp(0.0, 1.0)


def psnr(pred, target, data_range=1.0):
    """Mean PSNR over the batch (a 0-dim tensor).  pred/target: (..., H, W, C)."""
    p, t = _denorm(pred), _denorm(target)
    mse = ((p - t) ** 2).mean(dim=tuple(range(1, p.dim())))
    return torch.mean(10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12)))


def _gaussian_kernel(size=11, sigma=1.5, device="cpu"):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _ssim_map(pred, target, kernel_size=11, sigma=1.5, data_range=1.0, k1=0.01, k2=0.03):
    """The SSIM map (B, C, H', W') with a Gaussian window (pytorch-lightning's
    defaults), a depthwise VALID conv per channel.  pred/target: (B, H, W, C)."""
    p = _denorm(pred).float().permute(0, 3, 1, 2)
    t = _denorm(target).float().permute(0, 3, 1, 2)
    c = p.shape[1]
    win = _gaussian_kernel(kernel_size, sigma, p.device).repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x, win, groups=c)

    mu_p, mu_t = filt(p), filt(t)
    mu_pp = filt(p * p) - mu_p ** 2
    mu_tt = filt(t * t) - mu_t ** 2
    mu_pt = filt(p * t) - mu_p * mu_t
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    return ((2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (mu_pp + mu_tt + c2))


def ssim(pred, target, **kw):
    """Mean SSIM over the batch (``_ssim_map``'s window and constants).
    pred/target: (B, H, W, C)."""
    return torch.mean(_ssim_map(pred, target, **kw))


def ssim_per_frame(pred, target, **kw):
    """(B,) SSIM of each frame, as JAX's ``vmap`` of ``ssim`` over single
    frames.  pred/target: (B, H, W, C)."""
    return _ssim_map(pred, target, **kw).mean(dim=(1, 2, 3))


def ssim_video(pred, target, **kw):
    """(B, T, H, W, C): SSIM over every frame."""
    return ssim(pred.flatten(0, 1), target.flatten(0, 1), **kw)


def best_of_n_metric(metric_fn, samples, target):
    """The best-of-N protocol (the reference's SampleMetric): per example,
    the metric per frame for each of N samples, keeping the sample whose
    per-frame mean is least (the first of equal ones).

    samples: (N, B, T, H, W, C); target: (B, T, H, W, C); metric_fn:
    (frames_a, frames_b) -> (B*T,) per-frame values, lower is better.
    Returns (per-frame mean (T,), per-frame population std (T,)).
    """
    n, b, t = samples.shape[:3]
    flat_t = target.flatten(0, 1)
    vals = torch.stack([metric_fn(samples[i].flatten(0, 1), flat_t).reshape(b, t)
                        for i in range(n)])                       # (N, B, T)
    best = vals.mean(dim=2).argmin(dim=0)                         # (B,)
    chosen = torch.take_along_dim(vals, best[None, :, None], dim=0)[0]   # (B, T)
    return chosen.mean(dim=0), chosen.std(dim=0, correction=0)
