"""Invertible channel permutations (counterpart of ``ipoke_tpu/flows/permute.py``).

Shuffle: a fixed permutation, ``fwd_idx``/``inv_idx`` as ``torch.long``
buffers, from the checkpoint or from ``init_shuffle``; logdet = 0.

Conv-LU (``use_1x1``): an LU-parameterised invertible 1x1 conv,
``W = P (L * lmask + I) (U * lmask^T + diag(sign_s exp(log_s)))`` acting on
the channel vector; logdet = H W sum(log_s).  Its leaves are JAX's, every
one a float (the permutation matrix ``permutated`` too).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
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


def init_conv_lu(key, nf, device="cpu"):
    """JAX's ``init_conv_lu``: numpy's QR of JAX's normal draw from ``key``,
    then ``scipy.linalg.lu`` of the orthogonal factor, on the host."""
    draw = prng.normal(key, (nf, nf), "cpu").numpy()
    w_init = np.linalg.qr(draw)[0].astype(np.float32)
    perm, lower, upper = scipy.linalg.lu(w_init)
    s = np.diag(upper)
    leaves = {"permutated": perm, "sign_s": np.sign(s),
              "lmask": np.tril(np.ones_like(w_init), -1), "l": lower,
              "u": np.triu(upper, k=1), "log_s": np.log(np.abs(s))}
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(device)
            for k, v in leaves.items()}


def _lu_weight(p):
    eye = torch.eye(p["l"].shape[0], dtype=p["l"].dtype, device=p["l"].device)
    wl = p["l"] * p["lmask"] + eye
    wu = p["u"] * p["lmask"].T + torch.diag(p["sign_s"] * torch.exp(p["log_s"]))
    return p["permutated"] @ wl @ wu   # (out, in) on channel vectors


def conv_lu_forward(p, x):
    b, h, w, _ = x.shape
    y = x @ _lu_weight(p).to(x.dtype).T
    logdet = torch.full((b,), float(h * w), dtype=torch.float32, device=x.device)
    return y, logdet * p["log_s"].float().sum()


def conv_lu_inverse(p, y):
    w_inv = torch.linalg.inv(_lu_weight(p).float())
    return y @ w_inv.to(y.dtype).T
