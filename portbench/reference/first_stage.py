"""The first-stage video autoencoder: the 3D-ResNet motion encoder and the
ConvGRU + SPADE frame decoder.  ``fs`` is the configuration's
``first_stage`` section (``portbench/configs/<config>.json``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import nn, prng


def encoder_plan(fs):
    """(channels, stride1, stride4, has_layer4, has_layer5, last_channels) of
    the reference's motion encoder at these sizes."""
    channels = list(fs["enc_channels"])
    first_down = len(channels) - 1 < int(math.ceil(math.log2(fs["max_frames"]))) or fs["full_sequence"]
    stride1 = (2, 1, 1) if first_down else (1, 1, 1)
    stride4 = (2, 1, 1) if (fs["full_sequence"] and fs["max_frames"] >= 16) else None
    if fs["spatial_size"] // 8 > fs["min_spatial_size"]:
        stride4 = (2, 2, 2)
    has_l4 = stride4 is not None
    if has_l4 and len(channels) < 5:
        channels.append(channels[-1])
    has_l5 = fs["spatial_size"] // 16 > fs["min_spatial_size"]
    last = channels[5] if has_l5 else channels[4] if has_l4 else channels[3]
    return channels, stride1, stride4, has_l4, has_l5, last


def _basic_block(p, x, stride):
    out = F.relu(nn.group_norm(nn.conv3d(x, p["conv1"]["w"], stride, 1),
                               p["gn1"]["gamma"], p["gn1"]["beta"]))
    out = nn.group_norm(nn.conv3d(out, p["conv2"]["w"], 1, 1), p["gn2"]["gamma"], p["gn2"]["beta"])
    residual = x
    if "down" in p:
        residual = nn.group_norm(nn.conv3d(x, p["down"]["w"], stride, 0),
                                 p["down"]["gn"]["gamma"], p["down"]["gn"]["beta"])
    return F.relu(out + residual)


def encode(p, x, fs, rng=None):
    """video (B,T,S,S,3) -> (motion, mu, logvar), each (B,s,s,z); the motion
    is ``normal(rng) * exp(logvar / 2) + mu`` with a JAX key, else mu."""
    _, stride1, stride4, has_l4, has_l5, _ = encoder_plan(fs)
    out = F.relu(nn.group_norm(nn.conv3d(x, p["conv1"]["w"], (2, 2, 2), (1, 3, 3)),
                               p["gn1"]["gamma"], p["gn1"]["beta"]))
    layers = [("layer1", stride1), ("layer2", (2, 2, 2)), ("layer3", (2, 2, 2))]
    if has_l4:
        layers.append(("layer4", stride4))
    if has_l5:
        layers.append(("layer5", (2, 2, 2)))
    for name, stride in layers:
        for i, blk in enumerate(p[name]):
            out = _basic_block(blk, out, stride if i == 0 else (1, 1, 1))
    out = out.squeeze(1) if out.shape[1] == 1 else out.mean(dim=1)
    mu = nn.conv2d(out, p["conv_mu"]["w"], p["conv_mu"]["b"], padding=1)
    logvar = nn.conv2d(out, p["conv_var"]["w"], p["conv_var"]["b"], padding=1)
    if rng is None:
        return mu, mu, logvar
    eps = prng.normal(rng, tuple(logvar.shape), logvar.device)
    return eps * torch.exp(0.5 * logvar) + mu, mu, logvar


def _gru_cell(p, x, h):
    stacked = torch.cat([x, h], dim=-1)
    reset = torch.sigmoid(nn.conv2d(stacked, p["reset"]["w"], p["reset"]["b"], padding=1))
    update = torch.sigmoid(nn.conv2d(stacked, p["update"]["w"], p["update"]["b"], padding=1))
    out = torch.tanh(nn.conv2d(torch.cat([x, h * reset], dim=-1), p["out"]["w"], p["out"]["b"],
                               padding=1))
    return h * (1.0 - update) + out * update


def _spade_groups(c, groups=16):
    while c % groups:
        groups -= 1
    return groups


def _spade_mod(p, frame, hw):
    y = F.leaky_relu(nn.conv2d(nn.resize_bilinear(frame, hw), p["conv"]["w"], p["conv"]["b"],
                               padding=1), 0.2)
    return (nn.conv2d(y, p["conv_gamma"]["w"], p["conv_gamma"]["b"], padding=1),
            nn.conv2d(y, p["conv_beta"]["w"], p["conv_beta"]["b"], padding=1))


def _frame(gen, hidden, frame, fs):
    x = nn.res_block(gen["in_block"], hidden, norm="group")
    res = fs["min_spatial_size"]
    for blk, sp in zip(gen["blocks"], gen["spades"]):
        res *= 2
        x = nn.res_block(blk, x, norm="none", upsampling=True)
        gamma, beta = _spade_mod(sp, frame, (res, res))
        x = nn.group_norm(x, groups=_spade_groups(x.shape[-1])) * (1.0 + gamma) + beta
    return nn.conv_block(gen["out_conv"], x, act="tanh")


def decode(p, motion, frame, fs, length):
    """``length`` frames (B,length,S,S,3) from a motion latent (B,s,s,z) and
    a start frame (B,S,S,3): the GRU stack starts from the motion in every
    layer and reads the broadcast ``motion_bias`` at each step."""
    hidden = [motion] * fs["n_gru_layers"]
    x_in = p["motion_bias"].expand((motion.shape[0],) + tuple(p["motion_bias"].shape[1:]))
    frames = []
    for _ in range(length):
        new, inp = [], x_in
        for cell, h in zip(p["rnn"], hidden):
            inp = _gru_cell(cell, inp, h)
            new.append(inp)
        hidden = new
        frames.append(_frame(p["gen"], hidden[-1], frame, fs))
    return torch.stack(frames, dim=1)


def spectral_generator(p):
    """The generator with its decoder's spectral norms materialised; the
    upsampling blocks hold conv1 and res_conv as transpose convs."""
    gen = p["gen"]
    ups = [{k: nn.spectral_tree(v, transposed=k != "conv2") for k, v in b.items()}
           for b in gen["blocks"]]
    return dict(p, gen=dict(gen, in_block=nn.spectral_tree(gen["in_block"]), blocks=ups))
