"""``forward_sample`` in plain torch: the conditioning towers, the
multiscale MaCow flow's inverse and the first-stage decode.

Every masked-conv-flow (MCF) inverse is the row loop: the output row ``i``
is solved from the rows above it, one row at a time, so no kernel and no
reordered sum stands in for the recurrence.  Shapes follow ``cfg``, the
configuration file's sizes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import first_stage, nn


# --- sizes --------------------------------------------------------------------

def level_channels(cfg):
    fl = cfg["flow"]
    c, cs = cfg["first_stage"]["z_dim"], cfg["first_stage"]["z_dim"] // fl["factor"]
    return [c - i * cs for i in range(len(fl["num_steps"]))]


def level_factors(cfg):
    fl = cfg["flow"]
    return [fl["factor"] - i for i in range(len(fl["num_steps"]))]


def nice_split(c, factor, split, order):
    """(split, z1 channels) of a NICE coupling on ``c`` channels."""
    if split == "skip" and c % factor == 1:
        split = "continuous"
    out = c // factor
    return split, (c - out if order == "up" else out)


def mcf_hidden(c):
    return 4 * c if c <= 96 else min(2 * c, 512)


# --- conditioning towers --------------------------------------------------------

def encode_tower(p, x, variational):
    """(out, mean) of a conv encoder; a variational tower's mean comes from
    its weight-normed head."""
    out = nn.conv_block(p["stem"], x, stride=2, norm="group")
    for blk in p["blocks"]:
        out = nn.res_block(blk, out, norm="group", stride=2)
    mean = out
    out = nn.res_block(p["bottleneck"], out, norm="group")
    if variational:
        h = p["make_mu"]
        mean = h["gamma"] * nn.conv2d(out, nn.weight_norm(h["v"], h["g"]), h["b"], padding=1) + h["beta"]
    return out, mean


def embed_cond(params, x0, poke):
    """cat([image tower's mean, poke tower's output]): (B, s, s, h)."""
    poke_emb, _ = encode_tower(params["poke_embedder"]["encoder"], poke, False)
    _, cond = encode_tower(params["conditioner"]["encoder"], x0, True)
    return torch.cat([cond, poke_emb], dim=-1)


# --- flow pieces ----------------------------------------------------------------

def actnorm_inv(p, y):
    return (y - p["bias"]) / (torch.exp(p["log_scale"]) + 1e-8)


def affine_params(raw):
    mu, log_scale = torch.chunk(raw, 2, dim=-1)
    return mu, torch.tanh(log_scale * 0.5) + 1.0


def nice_inverse(p, y, factor, split, order):
    split, z1c = nice_split(y.shape[-1], factor, split, order)
    if split == "continuous":
        z1, z2 = y[..., :z1c], y[..., z1c:]
    else:
        z1, z2 = y[..., 0::2], y[..., 1::2]
    z, zp = (z1, z2) if order == "up" else (z2, z1)
    net = p["net"]
    out = F.elu(nn.conv2d(z, net["conv1"]["w"], padding=1))
    out = F.elu(nn.conv2d(out, net["conv2"]["w"]))
    c3 = net["conv3"]
    mu, scale = affine_params(nn.conv2d(out, nn.weight_norm(c3["v"], c3["g"]), c3["b"], padding=1))
    zp = (zp - mu) / (scale + 1e-12)
    z1, z2 = (z, zp) if order == "up" else (zp, z)
    if split == "continuous":
        return torch.cat([z1, z2], dim=-1)
    return torch.stack([z1, z2], dim=-1).flatten(-2)


def mcf_inverse(p, z, h, order):
    """The MCF inverse by its row loop.  Orders B, C and D are order A on a
    flipped or transposed latent: A solves rows top to bottom, B bottom to
    top, C columns left to right, D right to left."""
    net = p["net"]
    w = net["shift_conv"]["w"]
    w1 = nn.weight_norm(net["conv1x1"]["v"], net["conv1x1"]["g"]).reshape(net["conv1x1"]["v"].shape[0], -1)
    b1 = net["conv1x1"]["b"]
    if order in "CD":    # columns become rows: (B,W,H,C), the kernel (hid,C,kw,kh)
        z, h, w = z.transpose(1, 2), h.transpose(1, 2), w.transpose(2, 3)
    if order in "BD":    # scan the other way: flip the scanned axis and the kernel's
        z, h, w = z.flip(1), h.flip(1), w.flip(2)
    b, height, width, c = z.shape
    kh, kw = w.shape[2], w.shape[3]
    cw = (kw - 1) // 2
    buf = z.new_zeros((b, c, kh + height, width + 2 * cw))
    for i in range(height):
        ctx = F.conv2d(buf[:, :, i:i + kh], w)[:, :, 0].transpose(1, 2)   # (B, W, hid)
        ctx = torch.cat([ctx, h[:, i]], dim=-1)
        mu, scale = affine_params(F.elu(ctx) @ w1.t() + b1)
        buf[:, :, kh + i, cw:cw + width] = ((z[:, i] - mu) / (scale + 1e-12)).transpose(1, 2)
    x = buf[:, :, kh:, cw:cw + width].permute(0, 2, 3, 1)
    if order in "BD":
        x = x.flip(1)
    if order in "CD":
        x = x.transpose(1, 2)
    return x.contiguous()


def unit_inverse(p, y, h):
    out = actnorm_inv(p["actnorm2"], y)
    out = mcf_inverse(p["conv4"], out, h, "D")
    out = mcf_inverse(p["conv3"], out, h, "C")
    out = actnorm_inv(p["actnorm1"], out)
    out = mcf_inverse(p["conv2"], out, h, "B")
    return mcf_inverse(p["conv1"], out, h, "A")


def step_inverse(p, y, h):
    out = nice_inverse(p["coupling2_dn"], y, 2, "skip", "down")
    out = nice_inverse(p["coupling2_up"], out, 2, "skip", "up")
    for unit in reversed(p["units2"]):
        out = unit_inverse(unit, out, h)
    out = actnorm_inv(p["actnorm2"], out)
    out = nice_inverse(p["coupling1_dn"], out, 2, "continuous", "down")
    out = nice_inverse(p["coupling1_up"], out, 2, "continuous", "up")
    for unit in reversed(p["units1"]):
        out = unit_inverse(unit, out, h)
    out = out.index_select(-1, p["conv1x1"]["inv_idx"])
    return actnorm_inv(p["actnorm1"], out)


def flow_inverse(flow, cfg, z, h):
    """The multiscale flow's inverse: from the deepest level up, each level's
    split channels rejoin, its permutation and prior are undone, then its
    MaCowSteps in reverse."""
    chans = level_channels(cfg)
    cs = cfg["first_stage"]["z_dim"] // cfg["flow"]["factor"]
    out, z2s = z, []
    for c in chans:
        z2s.append(out[..., c - cs:c])
        out = out[..., :c - cs]
    for level, f, z2 in zip(reversed(flow["levels"]), reversed(level_factors(cfg)), reversed(z2s)):
        out = torch.cat([out, z2], dim=-1)
        out = out.index_select(-1, level["shuffle"]["inv_idx"])
        prior = level["prior"]
        _, z1c = nice_split(out.shape[-1], f, "continuous", "up")
        out = torch.cat([out[..., :z1c], actnorm_inv(prior["actnorm"], out[..., z1c:])], dim=-1)
        out = nice_inverse(prior["coupling"], out, f, "continuous", "up")
        out = out.index_select(-1, prior["conv1x1"]["inv_idx"])
        for step in reversed(level["steps"]):
            out = step_inverse(step, out, h)
    return out


@torch.no_grad()
def forward_sample(params, cfg, images, poke, z, length):
    """Videos (n, B, length, S, S, 3) from start frames ``images[:, 0]``,
    pokes (B, S, S, 2) and Gaussian draws ``z`` (n, B, s, s, C)."""
    x0 = images[:, 0]
    n, b = z.shape[0], x0.shape[0]
    cond = embed_cond(params, x0, poke)

    def rep(t):   # (B, ...) -> (n*B, ...), sample-major like z
        return t.unsqueeze(0).expand((n,) + tuple(t.shape)).reshape((n * b,) + tuple(t.shape[1:]))

    motion = flow_inverse(params["flow"], cfg, z.reshape((n * b,) + tuple(z.shape[2:])), rep(cond))
    vid = first_stage.decode(params["first_stage"], motion, rep(x0), cfg["first_stage"], length)
    return vid.reshape((n, b) + tuple(vid.shape[1:]))
