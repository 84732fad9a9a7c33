"""K1: the inverse of one affine masked-conv flow (MCF), canonical order A.

Replaces the TPU kernel ``ipoke_tpu/ops/pallas/mcf_inverse.py``
(``_kernel`` / ``_call`` / ``mcf_inverse_pallas``).  CUDA source:
``csrc/mcf_inverse.cu`` with the row scan of ``csrc/mcf_scan.cuh``.

For each row i, top to bottom:
    ctx  = conv(rows i-kh .. i-1 of the output, w_shift)      (zero padded)
    raw  = act(ctx ++ h[:, i]) @ w1^T + b1
    row  = (z[:, i] - mu) / (1 + alpha * tanh(logs / 2) + 1e-12)

What bounds it on the H100: f32 operations (the context conv and the 1x1
conv), but the H rows are a dependent chain, so one launch takes the chain's
latency, far above the operation bound.  The design gives each example one
block (grid = B), keeps the latent and the row activations in shared memory
for the whole recurrence, and reads the weights from L2/L1.

``mcf_inverse`` launches the kernel on CUDA tensors and takes the plain
version ``mcf_inverse_plain`` on CPU tensors only; ``mcf_inverse.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ipoke_tpu_torch.nn.core import activation
from ipoke_tpu_torch.ops.cuda import _build


def canonical(w_shift, z, h, order):
    """Map an MCF inverse of ``order`` onto canonical order A.

    w_shift: OIHW; z, h: NHWC.  Returns (w, z, h, undo): B flips H, C swaps
    H and W, D does both (the port's counterpart of the JAX ``_canonicalize``).
    """
    if order == "A":
        return w_shift, z, h, lambda x: x
    if order == "B":
        return (w_shift.flip(2), z.flip(1), None if h is None else h.flip(1),
                lambda x: x.flip(1))
    if order == "C":
        return (w_shift.transpose(2, 3), z.transpose(1, 2),
                None if h is None else h.transpose(1, 2), lambda x: x.transpose(1, 2))
    if order == "D":
        return (w_shift.transpose(2, 3).flip(2), z.transpose(1, 2).flip(1),
                None if h is None else h.transpose(1, 2).flip(1),
                lambda x: x.flip(1).transpose(1, 2))
    raise ValueError(order)


def mcf_inverse_plain(z, h, w_shift, w1, b1, alpha=1.0, act="elu"):
    """Plain PyTorch row loop of the same function as the kernel.

    z: (B,H,W,C); h: (B,H,W,hc) or None; w_shift: (hid, C, kh, kw);
    w1: (2C, hid + hc); b1: (2C,).  Returns (B,H,W,C).
    """
    b, height, width, c = z.shape
    kh, kw = w_shift.shape[2], w_shift.shape[3]
    cw = (kw - 1) // 2
    f = activation(act)
    # output rows in NCHW with kh zero rows above and cw zero columns per side
    buf = z.new_zeros((b, c, kh + height, width + 2 * cw))
    for i in range(height):
        ctx = F.conv2d(buf[:, :, i:i + kh], w_shift)[:, :, 0].transpose(1, 2)  # (B,W,hid)
        if h is not None:
            ctx = torch.cat([ctx, h[:, i]], dim=-1)
        raw = f(ctx) @ w1.t() + b1
        scale = torch.tanh(raw[..., c:] * 0.5) * alpha + 1.0
        row = (z[:, i] - raw[..., :c]) / (scale + 1e-12)
        buf[:, :, kh + i, cw:cw + width] = row.transpose(1, 2)
    return buf[:, :, kh:, cw:cw + width].permute(0, 2, 3, 1).contiguous()


def mcf_inverse(z, h, w_shift, w1, b1, alpha=1.0, act="elu"):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if z.device.type == "cpu":
        return mcf_inverse_plain(z, h, w_shift, w1, b1, alpha, act)
    if z.device.type != "cuda":
        raise ValueError(f"mcf_inverse: no kernel for device {z.device}")
    if act not in _build.ACT_CODES:
        raise ValueError(f"mcf_inverse: activation {act!r} not in {sorted(_build.ACT_CODES)}")
    dev = z.device
    _build.check_tensor("mcf_inverse z", z, dev, 4)
    b, height, width, c = z.shape
    hid, c_in, kh, kw = w_shift.shape
    hc = 0 if h is None else h.shape[-1]
    _build.check_tensor("mcf_inverse w_shift", w_shift, dev, 4)
    _build.check_tensor("mcf_inverse w1", w1, dev, 2)
    _build.check_tensor("mcf_inverse b1", b1, dev, 1)
    if h is not None:
        _build.check_tensor("mcf_inverse h", h, dev, 4)
        if tuple(h.shape[:3]) != (b, height, width):
            raise ValueError(f"mcf_inverse: h {tuple(h.shape)} does not match z {tuple(z.shape)}")
    if c_in != c or kw % 2 == 0 or tuple(w1.shape) != (2 * c, hid + hc) \
            or tuple(b1.shape) != (2 * c,):
        raise ValueError(
            f"mcf_inverse: shapes z {tuple(z.shape)}, w_shift {tuple(w_shift.shape)}, "
            f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, hc {hc} do not fit")
    out = torch.empty_like(z)
    err = _build.load("mcf_inverse")(
        z.data_ptr(), None if h is None else h.data_ptr(), w_shift.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), out.data_ptr(), b, height, width, c, hid, hc,
        kh, kw, float(alpha), _build.ACT_CODES[act], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("mcf_inverse", err)
    mcf_inverse.launches += 1
    return out


mcf_inverse.launches = 0
