"""PWC-lite: a learned coarse-to-fine optical-flow network on the op surface
of ``ops/flow_ops`` (correlation cost volume + bilinear warping), the data
preparation's flow estimator (counterpart of ``ipoke_tpu/ops/pwc.py``).

Architecture (PWC-Net, Sun et al. 2018, slimmed):
  * shared conv feature pyramid over both frames (levels 1/2 .. 1/2^L),
    here both frames in one batch;
  * per level, coarse->fine: upsample+scale the flow, warp the second
    frame's features by it, correlate (9x9 cost volume), and predict a
    residual flow from [cost, feat1, upflow] with a small conv stack.

Params are the JAX package's tree (``{"pyramid": [...], "estimators":
[...]}``) with the port's OIHW kernels.  ``init_pwc`` draws JAX's numbers
from JAX's key (``utils/prng``); the synthetic generators draw JAX's pairs;
``save_params``/``load_params`` read and write JAX's npz (``keystr`` paths,
HWIO kernels), so each package loads the other's ``pwc_lite.npz``.

Weights: ``$IPOKE_WEIGHTS/pwc_lite.npz`` if present; otherwise
``default_params`` fits the net from PRNGKey(1234) on procedural pairs on
the device it is given (900 Adam steps of 8 pairs at 64^2), as JAX's does.
The fit runs with deterministic algorithms (``reproducible``), so a key
gives the same net on a card every time.  ``data/prepare``'s CLI checks a
fit (``validate_fit``) before it writes one.

Flow convention matches flow_ops: flow[...,(0,1)] = (dy,dx) pixels,
img1(p) ~ img2(p + flow(p)).

    python -m ipoke_tpu_torch.ops.pwc [--device cpu]   # EPE table vs Horn-Schunck
"""
from __future__ import annotations

import logging
import math
import os
import zlib
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.nn.core import (
    conv2d,
    from_hwio,
    kaiming_uniform_torch_default,
    resize_bilinear_align_corners,
    to_hwio,
)
from ipoke_tpu_torch.ops.flow_ops import correlation_cost_volume, estimate_flow, warp_bilinear
from ipoke_tpu_torch.train.second_stage import adam, leaves
from ipoke_tpu_torch.utils import prng

LEVEL_CHANNELS = (16, 32, 64, 96)   # pyramid features at 1/2, 1/4, 1/8, 1/16
EST_CHANNELS = (96, 64, 32)         # flow-estimator conv stack
MAX_DISP = 4                        # 9x9 correlation window per level
LOSS_WEIGHTS = (0.32, 0.16, 0.08, 0.04)

log = logging.getLogger(__name__)


def _layout(in_channels=3):
    """Each conv's (in, out) channels, in the params' tree."""
    pyramid, ci = [], in_channels
    for co in LEVEL_CHANNELS:
        pyramid.append({"conv_a": (ci, co), "conv_b": (co, co)})
        ci = co
    cost_ch = (2 * MAX_DISP + 1) ** 2
    estimators = []
    for fc in LEVEL_CHANNELS:
        cin, convs = cost_ch + fc + 2, []
        for co in EST_CHANNELS + (2,):
            convs.append((cin, co))
            cin = co
        estimators.append(convs)
    return {"pyramid": pyramid, "estimators": estimators}


def _conv_p(key, ci, co, device):
    k1, _ = prng.split(key)
    w = kaiming_uniform_torch_default(k1, (3, 3, ci, co), device)
    return {"w": from_hwio(w), "b": torch.zeros(co, device=device)}


def init_pwc(key, in_channels=3, device="cpu"):
    """JAX's ``init_pwc(key)``: the pyramid's convs from ``split(key, 9)``,
    level l's estimator from ``fold_in(key, 100 + l)`` (conv j from
    ``fold_in(., j)``, the flow head from ``fold_in(., 99)``), zero biases."""
    layout = _layout(in_channels)
    ks = prng.split(key, 2 * len(LEVEL_CHANNELS) + 1)
    pyramid = [{name: _conv_p(ks[2 * li + j], *level[name], device)
                for j, name in enumerate(("conv_a", "conv_b"))}
               for li, level in enumerate(layout["pyramid"])]
    estimators = []
    for li, convs in enumerate(layout["estimators"]):
        kk = prng.fold_in(key, 100 + li)
        estimators.append([_conv_p(prng.fold_in(kk, j if j < len(convs) - 1 else 99), ci, co, device)
                           for j, (ci, co) in enumerate(convs)])
    return {"pyramid": pyramid, "estimators": estimators}


def _pyramid_apply(p, x):
    feats = []
    for level in p["pyramid"]:
        x = F.leaky_relu(conv2d(x, level["conv_a"]["w"], level["conv_a"]["b"],
                                stride=2, padding=1), 0.1)
        x = F.leaky_relu(conv2d(x, level["conv_b"]["w"], level["conv_b"]["b"], padding=1), 0.1)
        feats.append(x)
    return feats  # fine -> coarse


def _estimator_apply(convs, x):
    for cv in convs[:-1]:
        x = F.leaky_relu(conv2d(x, cv["w"], cv["b"], padding=1), 0.1)
    return conv2d(x, convs[-1]["w"], convs[-1]["b"], padding=1)


def _scale(size, like):
    return torch.tensor([size[0] / like.shape[1], size[1] / like.shape[2]],
                        dtype=like.dtype, device=like.device)


def _lerp(x, dim, n_out):
    """Align-corners linear resize of ``x`` along ``dim`` to ``n_out`` by two
    ``index_select``s, whose gradient (``index_add``) is deterministic on a
    card under ``reproducible``, unlike F.interpolate's."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    src = torch.arange(n_out, dtype=torch.float32, device=x.device) * (n_in - 1) / max(n_out - 1, 1)
    i0 = torch.clamp(torch.floor(src), 0, max(n_in - 2, 0))
    w = (src - i0).to(x.dtype)
    i0 = i0.long()
    shape = [1] * x.dim()
    shape[dim] = n_out
    w = w.reshape(shape)
    lo = x.index_select(dim, i0)
    hi = x.index_select(dim, torch.clamp(i0 + 1, max=n_in - 1))
    return lo * (1 - w) + hi * w


def _upsample_flow(flow, size):
    return _lerp(_lerp(flow, 1, size[0]), 2, size[1]) * _scale(size, flow)


@contextmanager
def exact_f32():
    """cuDNN's convs in f32 for the block (TF32 off), then the caller's
    setting again, so the card computes what the CPU computes and a flow
    file equals its recompute."""
    held = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = held


@contextmanager
def reproducible():
    """``exact_f32`` with deterministic algorithms for the block (cuDNN's
    and the gathers' gradients), then the caller's settings again: a fit
    from one key gives the same net on a card every time.  New tensors are
    not filled first (every op of the fit writes all of its output)."""
    import torch.utils.deterministic as det

    held = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    det.fill_uninitialized_memory = False
    try:
        with exact_f32():
            yield
    finally:
        torch.use_deterministic_algorithms(held[0], warn_only=held[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = held[2], held[3]
        det.fill_uninitialized_memory = held[4]


def pwc_flow_levels(params, frame1, frame2):
    """All pyramid-level flow predictions (coarse->fine), each in the pixel
    units of ITS level.  frames: (B,H,W,3) in [-1,1]."""
    b = frame1.shape[0]
    feats = _pyramid_apply(params, torch.cat([frame1, frame2]))
    flows = []
    flow = None
    for li in reversed(range(len(LEVEL_CHANNELS))):
        f1, f2 = feats[li][:b], feats[li][b:]
        if flow is None:
            # a zero flow warps f2 onto itself exactly: skip the gather
            up = torch.zeros(f1.shape[:3] + (2,), dtype=f1.dtype, device=f1.device)
            warped = f2
        else:
            up = _upsample_flow(flow, f1.shape[1:3])
            warped = warp_bilinear(f2, up)
        cost = F.leaky_relu(correlation_cost_volume(f1, warped, max_disp=MAX_DISP), 0.1)
        inp = torch.cat([cost, f1, up], dim=-1)
        flow = up + _estimator_apply(params["estimators"][li], inp)
        flows.append(flow)
    return flows  # [level L-1 (coarsest) ... level 0 (1/2 res)]


def pwc_flow(params, frame1, frame2):
    """Dense flow frame1 -> frame2 at full resolution, (B,H,W,2) (dy,dx)."""
    flow = pwc_flow_levels(params, frame1, frame2)[-1]
    return _upsample_flow(flow, frame1.shape[1:3])


# ---------------------------------------------------------------------------
# synthetic supervision: random smooth images warped by random smooth flows,
# drawn from JAX's keys
# ---------------------------------------------------------------------------

def _f32(v):
    return float(np.float32(v))


def _times(a, b):
    """JAX's product of a displacement and a Python float: f32 when the
    displacement is an f32 (the fit's curriculum), else in doubles."""
    return np.float32(a) * np.float32(b) if isinstance(a, np.float32) else a * b


def _smooth(coarse, h, w, scale=1.0):
    """A coarse normal draw times ``scale``, resized to (h, w)."""
    return resize_bilinear_align_corners(coarse * _f32(scale), (h, w))


def _grid(h, w, device):
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def synthetic_pair(key, b, h, w, max_disp=8.0, device="cpu"):
    """(img1, img2, flow_gt): img2 random smooth texture, flow_gt = global
    translation + smooth deformation, img1 = warp(img2, flow_gt)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    c1, c2, trans, c4 = prng.draws([("normal", k1, (b, 12, 12, 3)), ("normal", k2, (b, 24, 24, 3)),
                                    ("uniform", k3, (b, 1, 1, 2), -max_disp, max_disp),
                                    ("normal", k4, (b, 4, 4, 2))], device)
    img2 = torch.tanh(_smooth(c1, h, w, 1.5) + _smooth(c2, h, w, 0.7))
    flow_gt = trans + _smooth(c4, h, w, _times(max_disp, 0.15))
    img1 = warp_bilinear(img2, flow_gt)
    return img1, img2, flow_gt


def synthetic_pair_rotation(key, b, h, w, max_deg=12.0, device="cpu"):
    """Rotation regime: spatially-varying flow from a rotation about a
    random interior center (displacement grows linearly with radius)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    c1, c2, theta, center = prng.draws([("normal", k1, (b, 12, 12, 3)), ("normal", k2, (b, 24, 24, 3)),
                                        ("uniform", k3, (b,), -max_deg, max_deg),
                                        ("uniform", k4, (b, 2), 0.3, 0.7)], device)
    img2 = torch.tanh(_smooth(c1, h, w, 1.5) + _smooth(c2, h, w, 0.7))
    theta = theta * _f32(math.pi / 180.0)
    center = center * torch.tensor([h, w], dtype=torch.float32, device=device)
    yy, xx = _grid(h, w, device)
    dy = yy[None] - center[:, 0, None, None]
    dx = xx[None] - center[:, 1, None, None]
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    # flow(p) = R(p-c) + c - p  (img1(p) ~ img2(p + flow(p)))
    flow_gt = torch.stack([(c - 1.0) * dy - s * dx, s * dy + (c - 1.0) * dx], dim=-1)
    img1 = warp_bilinear(img2, flow_gt)
    return img1, img2, flow_gt


def synthetic_pair_layered(key, b, h, w, max_disp=8.0, device="cpu"):
    """Layered-motion / occlusion regime: a textured foreground blob over an
    opposing background, both frames composited from the layers.  Returns
    (img1, img2, flow_gt, occ_band), occ_band (B,H,W) the boundary band
    where occlusion makes flow photometrically ill-posed."""
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    c1, c2, v_fg, center, radius = prng.draws([
        ("normal", k1, (b, 12, 12, 3)), ("normal", k2, (b, 20, 20, 3)),
        ("uniform", k3, (b, 1, 1, 2), -max_disp, max_disp), ("uniform", k4, (b, 2), 0.35, 0.65),
        ("uniform", k5, (b, 1, 1), _f32(h / 6.0), _f32(h / 3.5))], device)
    bg_tex = torch.tanh(_smooth(c1, h, w, 1.5))
    fg_tex = torch.tanh(_smooth(c2, h, w, 1.5))
    v_bg = -0.35 * v_fg
    center = center * torch.tensor([h, w], dtype=torch.float32, device=device)
    yy, xx = _grid(h, w, device)

    def blob(cy, cx):
        d = torch.sqrt((yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2)
        return torch.sigmoid((radius - d) / 1.5)

    m1 = blob(center[:, 0], center[:, 1])
    m2 = blob(center[:, 0] + v_fg[:, 0, 0, 0], center[:, 1] + v_fg[:, 0, 0, 1])
    fg2 = warp_bilinear(fg_tex, (-v_fg).expand(b, h, w, 2))
    bg2 = warp_bilinear(bg_tex, (-v_bg).expand(b, h, w, 2))
    img1 = m1[..., None] * fg_tex + (1 - m1[..., None]) * bg_tex
    img2 = m2[..., None] * fg2 + (1 - m2[..., None]) * bg2
    flow_gt = m1[..., None] * v_fg + (1 - m1[..., None]) * v_bg
    occ_band = ((m1 > 0.02) | (m2 > 0.02)) & ~((m1 > 0.98) & (m2 > 0.98))
    return img1, img2, flow_gt, occ_band


def multiscale_epe_loss(params, img1, img2, flow_gt):
    """Supervised multi-scale EPE (PWC-Net training loss, per-level weights)."""
    flows = pwc_flow_levels(params, img1, img2)
    total = 0.0
    for wgt, fl in zip(LOSS_WEIGHTS[: len(flows)], flows):
        size = fl.shape[1:3]
        gt = resize_bilinear_align_corners(flow_gt, size) * _scale(size, flow_gt)
        total = total + wgt * torch.mean(torch.sqrt(torch.sum((fl - gt) ** 2, dim=-1) + 1e-8))
    return total


def _regimes():
    """The fit's step cycle: translation+deformation three times, rotation
    (+-14 degrees, whatever the curriculum says), layered/occlusion."""
    rotation = lambda k, b, h, w, md, device: synthetic_pair_rotation(  # noqa: E731
        k, b, h, w, max_deg=14.0, device=device)
    return [synthetic_pair, synthetic_pair, synthetic_pair, rotation, synthetic_pair_layered]


def curriculum(i, steps, max_disp=12.0):
    """Step ``i``'s largest displacement: 35% of ``max_disp`` ramping to all
    of it over the first 60% of the steps, as an f32 (JAX's ``jnp.float32``)."""
    return np.float32(max_disp * min(1.0, 0.35 + 0.65 * i / max(1, int(steps * 0.6))))


def fit_step(params, optimizer, opt_state, key, md, gen, batch=8, size=64):
    """One Adam step on a batch of ``gen``'s pairs drawn from ``key`` at
    displacement ``md``; params updated in place.  Returns the loss."""
    device = params["pyramid"][0]["conv_a"]["w"].device
    p = leaves(params)
    with torch.no_grad():
        out = gen(key, batch, size, size, md, device=device)
    loss = multiscale_epe_loss(params, out[0], out[1], out[2])
    grads = torch.autograd.grad(loss, p)
    with torch.no_grad():
        torch._foreach_add_(p, optimizer.update(list(grads), opt_state, p))
    return loss.detach()


def train_synthetic(key, steps=900, batch=8, size=64, max_disp=12.0, lr=1e-3, device=None):
    """Fit PWC-lite on procedural pairs, as JAX's ``train_synthetic``: init
    from ``fold_in(key, 0)``, optax's ``adam(lr)``, step i on the regime
    ``i % 5`` with key ``fold_in(key, i + 1)`` and the displacement
    curriculum, in f32 with deterministic algorithms (``reproducible``).
    Returns the trained params on ``device``."""
    device = resolve_device(device)
    params = init_pwc(prng.fold_in(key, 0), device=device)
    for t in leaves(params):
        t.requires_grad_(True)
    optimizer = adam(lr)
    opt_state = optimizer.init(params)
    regimes = _regimes()
    with reproducible():
        for i in range(steps):
            fit_step(params, optimizer, opt_state, prng.fold_in(key, i + 1),
                     curriculum(i, steps, max_disp), regimes[i % len(regimes)], batch, size)
    for t in leaves(params):
        t.requires_grad_(False)
    return params


# ---------------------------------------------------------------------------
# weights IO + prepare-pipeline entry
# ---------------------------------------------------------------------------

def _weights_path():
    return os.path.join(
        os.environ.get("IPOKE_WEIGHTS", os.path.join("logs", "weights")), "pwc_lite.npz"
    )


def _flatten(tree, prefix=""):
    """(``jax.tree_util.keystr`` path, leaf) pairs: ``['k']`` per dict key,
    ``[i]`` per list index."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def save_params(params, path=None):
    """JAX's npz: keystr paths, HWIO kernels, f32."""
    path = path or _weights_path()
    out = {}
    for k, v in _flatten(params):
        v = v.detach().cpu()
        out[k] = (to_hwio(v) if v.dim() == 4 else v).numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **out)
    return path


def load_params(path=None, device="cpu"):
    """A ``pwc_lite.npz`` of either package, on ``device``."""
    data = np.load(path or _weights_path())

    def conv(prefix):
        return {"w": from_hwio(torch.from_numpy(data[f"{prefix}['w']"])).to(device),
                "b": torch.from_numpy(data[f"{prefix}['b']"]).to(device)}

    layout = _layout()
    return {"pyramid": [{name: conv(f"['pyramid'][{li}][{name!r}]") for name in level}
                        for li, level in enumerate(layout["pyramid"])],
            "estimators": [[conv(f"['estimators'][{li}][{j}]") for j in range(len(convs))]
                           for li, convs in enumerate(layout["estimators"])]}


def validate_fit(params, device=None, b=24):
    """``regime_guards`` on validation pairs: the same regimes and checks on
    ``b`` pairs each from ``fold_in(PRNGKey(7), r)``, which no guard, fit
    step or table draws."""
    return regime_guards(params, device, [prng.fold_in(prng.prng_key(7), r) for r in range(5)], b)


@lru_cache(maxsize=None)
def default_params(device=None):
    """Trained params on ``device`` (the card by default): from
    pwc_lite.npz when present, else the synthetic fit from PRNGKey(1234),
    as JAX's ``default_params`` (cached per process; nothing written)."""
    device = resolve_device(device)
    path = _weights_path()
    if os.path.exists(path):
        return load_params(path, device)
    log.info("pwc: %s not found; fitting PWC-lite on synthetic pairs on %s", path, device)
    return train_synthetic(prng.prng_key(1234), device=device)


def estimate_flow_pwc(frame1, frame2, params=None):
    """Drop-in for flow_ops.estimate_flow with a learned estimator."""
    params = default_params(frame1.device) if params is None else params
    return pwc_flow(params, frame1, frame2)


def _epe(flow, gt, mask=None):
    e = torch.sqrt(torch.sum((flow - gt) ** 2, dim=-1) + 1e-12)
    if mask is None:
        return float(torch.mean(e))
    return float(torch.sum(e * mask) / torch.clamp(torch.sum(mask), min=1.0))


def _mean_disp(gt):
    return float(torch.mean(torch.sqrt(torch.sum(gt**2, -1))))


def eval_table(params=None, size=64, b=24, seed=999, device=None):
    """EPE of PWC-lite vs Horn-Schunck across the guard regimes.  The
    layered regime also splits EPE inside vs outside the occlusion band."""
    device = resolve_device(device)
    params = default_params(device) if params is None else params
    k = prng.prng_key(seed)
    rows = []
    with torch.no_grad():
        for name, gen in [
            ("translation+deform 7px", lambda kk: synthetic_pair(kk, b, size, size, 7.0, device)),
            ("translation+deform 12px", lambda kk: synthetic_pair(kk, b, size, size, 12.0, device)),
            ("rotation +-12deg", lambda kk: synthetic_pair_rotation(kk, b, size, size, 12.0, device)),
            ("layered/occlusion 8px", lambda kk: synthetic_pair_layered(kk, b, size, size, 8.0, device)),
        ]:
            out = gen(prng.fold_in(k, zlib.crc32(name.encode()) % 1000))
            img1, img2, gt = out[0], out[1], out[2]
            occ = out[3].float() if len(out) > 3 else None
            f_pwc = pwc_flow(params, img1, img2)
            f_hs = estimate_flow(img1, img2)
            row = {
                "regime": name,
                "mean_disp_px": round(_mean_disp(gt), 2),
                "epe_pwc": round(_epe(f_pwc, gt), 2),
                "epe_hs": round(_epe(f_hs, gt), 2),
            }
            if occ is not None:
                row["epe_pwc_occband"] = round(_epe(f_pwc, gt, occ), 2)
                row["epe_pwc_clean"] = round(_epe(f_pwc, gt, 1.0 - occ), 2)
            rows.append(row)
    return rows


GUARD_KEYS = (999, 77, 31, 57, 123)   # the held-out pairs of the JAX package's tests/test_pwc.py


def regime_guards(params, device=None, keys=None, b=6):
    """The guards the JAX package's tests/test_pwc.py holds a fitted
    PWC-lite to, on held-out pairs of ``b`` at 64^2 (that file's 6) drawn on
    ``device`` from ``keys`` (five, by default that file's): ``[(check,
    value, limit, against_hs)]``, each passing when value < limit.  Against
    Horn-Schunck (``against_hs``): PWC must beat it by 30% at 7 px and
    outright at 12 px, under rotation and with occlusion, and its warp must
    cut the photometric error of no flow to under 65%.  The absolute
    ceilings: under 2 px EPE at 7 px, under 40% of the mean displacement at
    12 px and 50% under rotation and on the clean region of the layered
    regime."""
    device = resolve_device(device)
    keys = [prng.prng_key(k) for k in GUARD_KEYS] if keys is None else keys
    out = []
    with torch.no_grad():
        img1, img2, gt = synthetic_pair(keys[0], b, 64, 64, 7.0, device)
        epe_pwc, epe_hs = _epe(pwc_flow(params, img1, img2), gt), _epe(estimate_flow(img1, img2), gt)
        out += [("7px: pwc EPE < 0.7 hs EPE", epe_pwc, 0.7 * epe_hs, True),
                ("7px: pwc EPE < 2 px", epe_pwc, 2.0, False)]

        img1, img2, gt = synthetic_pair(keys[1], b, 64, 64, 12.0, device)
        epe_pwc, epe_hs = _epe(pwc_flow(params, img1, img2), gt), _epe(estimate_flow(img1, img2), gt)
        out += [("12px: pwc EPE < 0.4 mean displacement", epe_pwc, 0.4 * _mean_disp(gt), False),
                ("12px: pwc EPE < hs EPE", epe_pwc, epe_hs, True)]

        img1, img2, gt = synthetic_pair_rotation(keys[2], b, 64, 64, 12.0, device)
        epe_pwc, epe_hs = _epe(pwc_flow(params, img1, img2), gt), _epe(estimate_flow(img1, img2), gt)
        out += [("rotation: pwc EPE < hs EPE", epe_pwc, epe_hs, True),
                ("rotation: pwc EPE < 0.5 mean displacement", epe_pwc, 0.5 * _mean_disp(gt), False)]

        img1, img2, gt, occ = synthetic_pair_layered(keys[3], b, 64, 64, 8.0, device)
        f_pwc = pwc_flow(params, img1, img2)
        epe_pwc, epe_hs = _epe(f_pwc, gt), _epe(estimate_flow(img1, img2), gt)
        out += [("layered: pwc EPE < hs EPE", epe_pwc, epe_hs, True),
                ("layered: clean-region pwc EPE < 0.5 mean displacement",
                 _epe(f_pwc, gt, 1.0 - occ.float()), 0.5 * _mean_disp(gt), False)]

        img1, img2, _ = synthetic_pair(keys[4], b, 64, 64, 6.0, device)
        flow = pwc_flow(params, img1, img2)
        out.append(("photometric: |warp(img2) - img1| < 0.65 |img2 - img1|",
                    float(torch.mean(torch.abs(warp_bilinear(img2, flow) - img1))),
                    0.65 * float(torch.mean(torch.abs(img2 - img1))), True))
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.ops.pwc")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    for r in eval_table(device=args.device):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
