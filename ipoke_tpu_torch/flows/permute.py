"""Fixed channel shuffle (counterpart of the shuffle half of
``ipoke_tpu/flows/permute.py``).  ``fwd_idx``/``inv_idx`` are ``torch.long``
buffers that come from the checkpoint; logdet = 0.  The LU-parameterised 1x1
conv (``use_1x1``) waits in ROADMAP queue 1.
"""
from __future__ import annotations

import torch


def shuffle_forward(p, x):
    return x.index_select(-1, p["fwd_idx"]), torch.zeros(
        (x.shape[0],), dtype=torch.float32, device=x.device)


def shuffle_inverse(p, y):
    return y.index_select(-1, p["inv_idx"])
