"""Convolutional GRU (counterpart of ``ipoke_tpu/models/conv_gru.py``)."""
from __future__ import annotations

import torch

from ipoke_tpu_torch.nn.core import conv2d


def cell_apply(p, x, h, kernel_size=3):
    pad = kernel_size // 2
    stacked = torch.cat([x, h], dim=-1)
    # reset and update read the same input with the same kernel geometry: one
    # conv with both kernels stacked on the output axis (OIHW dim 0)
    hidden = p["reset"]["w"].shape[0]
    w_ru = torch.cat([p["reset"]["w"], p["update"]["w"]], dim=0)
    b_ru = torch.cat([p["reset"]["b"], p["update"]["b"]])
    ru = torch.sigmoid(conv2d(stacked, w_ru, b_ru, padding=pad))
    reset, update = ru[..., :hidden], ru[..., hidden:]
    out_in = torch.cat([x, h * reset], dim=-1)
    out = torch.tanh(conv2d(out_in, p["out"]["w"], p["out"]["b"], padding=pad))
    return h * (1.0 - update) + out * update


def stack_apply(cells, x, hidden, kernel_size=3):
    """hidden: list of (B,H,W,C) states, one per layer.  Returns the new list."""
    new_hidden = []
    inp = x
    for cell, h in zip(cells, hidden):
        inp = cell_apply(cell, inp, h, kernel_size)
        new_hidden.append(inp)
    return new_hidden
