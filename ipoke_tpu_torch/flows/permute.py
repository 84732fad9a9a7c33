"""Fixed channel shuffle (counterpart of the shuffle half of
``ipoke_tpu/flows/permute.py``).  ``fwd_idx``/``inv_idx`` are ``torch.long``
buffers, from the checkpoint or from ``init_shuffle``; logdet = 0.  The
LU-parameterised 1x1 conv (``use_1x1``) waits in ROADMAP queue 1.
"""
from __future__ import annotations

import torch

from ipoke_tpu_torch.utils import prng


def init_shuffle(key, channels, device="cpu"):
    idx = prng.permutation(key, channels, device)
    return {"fwd_idx": idx, "inv_idx": torch.argsort(idx)}


def shuffle_forward(p, x):
    return x.index_select(-1, p["fwd_idx"]), torch.zeros(
        (x.shape[0],), dtype=torch.float32, device=x.device)


def shuffle_inverse(p, y):
    return y.index_select(-1, p["inv_idx"])
