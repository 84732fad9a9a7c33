"""Optical-flow building blocks (counterpart of ``ipoke_tpu/ops/flow_ops.py``):

  correlation_cost_volume : FlowNet-C correlation (mean over channels of a
                            zero-padded shift, one channel per displacement)
  warp_bilinear           : resample2d (bilinear gather by flow, clamped)
  channel_norm            : L2 over channels

and the weight-free coarse-to-fine Horn-Schunck solver, the data
preparation's fallback estimator.  NHWC at every function, flow channels
``(dy, dx)`` in pixels, as in the JAX package.  These are XLA ops there, not
Pallas kernels; here they are plain torch ops on the device of their inputs.
The correlation takes all its displacements from one strided view of the
padded second map, so it is two ops where JAX stacks one per displacement.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn.core import resize_bilinear_align_corners


def channel_norm(x, eps=1e-8):
    """(B,H,W,C) -> (B,H,W,1) L2 norm over channels."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def correlation_cost_volume(f1, f2, max_disp=4, stride=1):
    """f1, f2: (B,H,W,C).  Output (B,H,W,D^2) with D = len(range(-max_disp,
    max_disp+1, stride)); channel (dy, dx), dy outer and dx inner, is
    mean_c f1[x] * f2[x + (dy, dx)] with f2 zero-padded at the borders."""
    b, h, w, c = f1.shape
    f2p = F.pad(f2, (0, 0, max_disp, max_disp, max_disp, max_disp))
    # (B, Dy, Dx, C, H, W): window (dy, dx) of the padded map, a view
    win = f2p.unfold(1, h, 1)[:, ::stride].unfold(2, w, 1)[:, :, ::stride]
    cost = (f1.permute(0, 3, 1, 2)[:, None, None] * win).mean(dim=3)
    return cost.flatten(1, 2).permute(0, 2, 3, 1)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(lo, x), hi)``, whose gradient at a
    tie is split in halves (``torch.clamp`` passes all of it)."""
    lo = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(lo, x), hi)


def warp_bilinear(x, flow):
    """resample2d parity: sample x at (i + flow_y, j + flow_x).

    x: (B,H,W,C); flow: (B,H,W,2) with channels (dy, dx) in pixels.  The
    sample position clamps to the border, its top-left corner to the last
    but one row and column; the four corners are gathered in one call."""
    b, h, w, c = x.shape
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    sy = _clip(yy + flow[..., 0], 0.0, h - 1.0)
    sx = _clip(xx + flow[..., 1], 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(sy.detach()), 0, h - 2)
    x0 = torch.clamp(torch.floor(sx.detach()), 0, w - 2)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    idx = torch.stack([y0 * w + x0, y0 * w + x0 + 1, (y0 + 1) * w + x0, (y0 + 1) * w + x0 + 1], 1)
    idx = idx.reshape(b, 4 * h * w, 1).expand(b, 4 * h * w, c)
    v = torch.gather(x.reshape(b, h * w, c), 1, idx).reshape(b, 4, h, w, c)
    v00, v01, v10, v11 = v.unbind(1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


# ---------------------------------------------------------------------------
# pyramid flow solver: coarse-to-fine Horn-Schunck with warping
# linearisation, needing no weights
# ---------------------------------------------------------------------------

def _gray(x):
    return torch.mean(x, dim=-1, keepdim=True)


def _resize(x, size):
    return resize_bilinear_align_corners(x, size)


def _gradients(img):
    """``jnp.gradient`` along H and W: central inside, one-sided at the edges."""
    dy, dx = torch.gradient(img, dim=(1, 2), edge_order=1)
    return dy, dx


def _avg(f):
    """The HS neighbourhood mean of each flow channel: JAX's (3,3,2,2) conv
    with the kernel on its diagonal, here a depthwise conv, zero-padded."""
    k = torch.tensor([[1, 2, 1], [2, 0, 2], [1, 2, 1]], dtype=f.dtype, device=f.device) / 12.0
    y = F.conv2d(f.permute(0, 3, 1, 2), k.expand(2, 1, 3, 3), padding=1, groups=2)
    return y.permute(0, 2, 3, 1)


def horn_schunck_level(img1, img2, flow, n_iters=30, alpha=0.5):
    """One pyramid level of Horn-Schunck with warping linearisation."""
    for _ in range(n_iters):
        warped = warp_bilinear(img2, flow)
        it = warped - img1
        iy, ix = _gradients(warped)
        iy, ix, it = iy[..., 0], ix[..., 0], it[..., 0]
        fbar = _avg(flow)
        num = iy * fbar[..., 0] + ix * fbar[..., 1] + it
        den = alpha**2 + iy * iy + ix * ix
        upd = num / den
        flow = torch.stack([fbar[..., 0] - iy * upd, fbar[..., 1] - ix * upd], dim=-1)
    return flow


def estimate_flow(frame1, frame2, n_levels=4, n_iters=60, alpha=0.5):
    """Dense flow frame1 -> frame2.  frames: (B,H,W,3) in [-1,1].
    Returns (B,H,W,2) flow in pixels (dy, dx).  The direction comes out
    faithfully; large displacements are underestimated (HS's bias)."""
    g1, g2 = _gray(frame1), _gray(frame2)
    b, h, w, _ = g1.shape
    sizes = [(max(h >> lv, 8), max(w >> lv, 8)) for lv in range(n_levels)][::-1]
    flow = torch.zeros((b,) + sizes[0] + (2,), dtype=frame1.dtype, device=frame1.device)
    for size in sizes:
        p1 = _resize(g1, size)
        p2 = _resize(g2, size)
        if tuple(flow.shape[1:3]) != size:
            scale = torch.tensor([size[0] / flow.shape[1], size[1] / flow.shape[2]],
                                 dtype=flow.dtype, device=flow.device)
            flow = _resize(flow, size) * scale
        flow = horn_schunck_level(p1, p2, flow, n_iters=n_iters, alpha=alpha)
    return flow
