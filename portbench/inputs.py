"""The cells' inputs, made on the device from the seed: every draw comes from
a ``torch.Generator`` seeded by ``stream(seed, tag, i)``, so the same seed
gives the same inputs to the port and to the reference."""
from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

MASK64 = (1 << 63) - 1


def stream(seed, tag, i=0):
    """A 63-bit generator seed for draw ``i`` of kind ``tag`` under ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}:{int(i)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & MASK64


def generator(device, seed, tag, i=0):
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, tag, i))
    return g


def start_frames(g, b, size, device):
    """(b, size, size, 3) images in [-1, 1]: coloured noise at 1/8 of the
    size, upsampled bilinearly, through tanh: smooth structure at every
    position, as a photograph has."""
    low = torch.randn((b, 3, size // 8, size // 8), generator=g, device=device)
    img = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    return torch.tanh(1.5 * img).permute(0, 2, 3, 1).contiguous()


def sparse_pokes(g, b, size, device, poke_size=5, n_pokes=1, scale=3.0):
    """(b, size, size, 2) pokes: ``n_pokes`` patches of ``poke_size`` x
    ``poke_size`` pixels per image, each holding one 2-vector of N(0,
    scale^2) pixels, at positions uniform inside a ``poke_size`` border, the
    rest zero (the datasets' simulated pokes)."""
    lo, hi = poke_size, size - poke_size
    pos = torch.randint(lo, hi, (b, n_pokes, 2), generator=g, device=device)
    vec = scale * torch.randn((b, n_pokes, 2), generator=g, device=device)
    ar = torch.arange(size, device=device)
    half = poke_size // 2
    in_y = (ar[None, None, :] - pos[..., 0:1]).abs() <= half          # (b, n, size)
    in_x = (ar[None, None, :] - pos[..., 1:2]).abs() <= half
    mask = (in_y[..., :, None] & in_x[..., None, :]).float()           # (b, n, size, size)
    return torch.einsum("bnyx,bnc->byxc", mask, vec)


def gaussian_z(g, n, b, latent, channels, device):
    return torch.randn((n, b, latent, latent, channels), generator=g, device=device)


def blob_videos(g, b, t, size, device):
    """(b, t, size, size, 3) videos in [-1, 1]: a coloured Gaussian blob
    drifting at a constant velocity over a tinted background."""
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g, device=device)  # noqa: E731
    c0, vel = u((b, 2), 0.25, 0.75), u((b, 2), -0.03, 0.03)
    color, tint = u((b, 3), 0.3, 1.0), u((b, 3), -0.6, 0.0)
    sign = torch.sign(torch.randn((b, 3), generator=g, device=device))
    grid = torch.linspace(0.0, 1.0, size, device=device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    steps = torch.arange(t, dtype=torch.float32, device=device)[None, :, None]
    ctr = c0[:, None, :] + vel[:, None, :] * steps
    d2 = (gy[None, None] - ctr[..., 0:1, None]) ** 2 + (gx[None, None] - ctr[..., 1:2, None]) ** 2
    blob = torch.exp(-d2 / (2 * 0.008))
    per_video = lambda v: v[:, None, None, None, :]  # noqa: E731
    vids = per_video(tint) + per_video(sign) * per_video(color) * blob[..., None]
    return torch.clamp(vids, -1.0, 1.0)

