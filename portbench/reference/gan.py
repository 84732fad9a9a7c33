"""One stage-1 cVAE-GAN train step in plain torch.

The step updates, in order: the temporal 3D discriminator on a crop of
``mf_dt`` frames (hinge loss plus the gradient penalty on the real crop, a
double backward), the spatial PatchGAN on single frames, then the generator
against the updated discriminators (their hinge losses, the temporal
discriminator's feature-map L1, VGG19's perceptual L1, pixel L1 and KL).
Spectral norms are materialised inside each loss; the discriminators'
stored ``u`` are refreshed after their updates.  Each net has Adam(0.5, 0.9)
with coupled weight decay and a per-epoch staircase learning rate.

``nets`` holds ``gen``, ``ds`` and ``dt`` trees; ``tcfg`` is the traffic
file's ``gan`` section.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import first_stage, nn, prng

NETS = ("gen", "ds", "dt")

# VGG19's ``features`` up to relu5_1: (torchvision conv index, in, out), 'M' a max pool
VGG19_LAYOUT = [(0, 3, 64), (2, 64, 64), "M", (5, 64, 128), (7, 128, 128), "M",
                (10, 128, 256), (12, 256, 256), (14, 256, 256), (16, 256, 256), "M",
                (19, 256, 512), (21, 512, 512), (23, 512, 512), (25, 512, 512), "M",
                (28, 512, 512)]
VGG19_TAPS = (1, 6, 11, 20, 29)


def vgg19_filters(device):
    """The seeded VGG19 filters that stand in for the pretrained ones (the
    draw of ``numpy.random.default_rng(0)``, HWIO, scale sqrt(2 / (9 c_in)),
    the product in float64), as float32 OIHW tensors on ``device``."""
    rng = np.random.default_rng(0)
    out = {}
    for item in VGG19_LAYOUT:
        if item == "M":
            continue
        idx, c_in, c_out = item
        w = rng.standard_normal((3, 3, c_in, c_out)).astype(np.float32) * np.sqrt(2.0 / (9 * c_in))
        out[idx] = (torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).float().to(device),
                    torch.zeros(c_out, device=device))
    return out


def vgg_features(filters, x):
    feats, cur = [], x
    for item in VGG19_LAYOUT:
        if item == "M":
            cur = nn.nhwc(F.max_pool2d(nn.nchw(cur), 2))
            continue
        w, b = filters[item[0]]
        cur = F.relu(nn.conv2d(cur, w, b, padding=1))
        if item[0] + 1 in VGG19_TAPS:
            feats.append(cur)
    return feats


def vgg_loss(filters, x, y):
    fx, fy = vgg_features(filters, x), vgg_features(filters, y)
    return sum(torch.mean((a - b).abs()) for a, b in zip(fx, fy)) / len(fx)


def patch_disc(p, x):
    x = F.leaky_relu(nn.conv2d(x, p["in_conv"]["w"], p["in_conv"]["b"], stride=2, padding=1), 0.2)
    fmaps, n = [], len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = nn.conv2d(x, layer["w"], layer["b"], stride=2 if i < n - 1 else 1, padding=1)
        x = F.leaky_relu(nn.instance_norm(x), 0.2)
        fmaps.append(x)
    return nn.conv2d(x, p["out_conv"]["w"], p["out_conv"]["b"], padding=1), fmaps


def _block3d(p, x, stride, stride_t):
    s = (stride_t, stride, stride)
    out = F.relu(nn.group_norm(nn.conv3d(x, p["conv1"]["w"], s, 1), p["gn1"]["gamma"], p["gn1"]["beta"]))
    out = nn.group_norm(nn.conv3d(out, p["conv2"]["w"], 1, 1), p["gn2"]["gamma"], p["gn2"]["beta"])
    residual = x
    if "down" in p:
        residual = nn.group_norm(nn.conv3d(x, p["down"]["w"], s, 1),
                                 p["down_gn"]["gamma"], p["down_gn"]["beta"])
    return F.relu(out + residual)


def temp_disc(p, x):
    """x (B,T,H,W,3) -> (pred (B, T'), the four layers' feature maps)."""
    y = nn.conv3d(x, p["conv1"]["w"], (1, 2, 2), (1, 3, 3))
    y = F.relu(nn.group_norm(y, p["gn1"]["gamma"], p["gn1"]["beta"]))
    y = F.max_pool3d(y.movedim(-1, 1), 3, stride=(1, 2, 2), padding=1).movedim(1, -1)
    fmaps = []
    for name, stride, stride_t in (("layer1", 1, 1), ("layer2", 1, 2), ("layer3", 2, 2),
                                   ("layer4", 2, 2)):
        for i, blk in enumerate(p[name]):
            y = _block3d(blk, y, stride if i == 0 else 1, stride_t if i == 0 else 1)
        fmaps.append(y)
    y = y.mean(dim=(2, 3))
    return torch.einsum("btc,cn->btn", y, p["fc"]["w"]).reshape(y.shape[0], -1), fmaps


def hinge(pred, real):
    return torch.mean(F.relu(1.0 - pred if real else 1.0 + pred))


def trainable(tree):
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items() if k != "u"}
    if isinstance(tree, list):
        return [trainable(v) for v in tree]
    return tree


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def crop_plan(key, b, t, mf_dt, n_spatial):
    r1, r2, r3 = prng.split(key, 3)
    size = min(mf_dt, t)
    offset = min(max(int(prng.randint(r1, (), 0, max(1, t - mf_dt))), 0), t - size)
    return (offset, size, prng.randint(r2, (n_spatial,), 0, b * t),
            prng.randint(r3, (n_spatial,), 0, b * (t - 1)))


def crops(x, x_hat, plan):
    offset, size, i_true, i_fake = plan
    fake_full = torch.cat([x[:, :1], x_hat], dim=1)
    flat = lambda v: v.reshape((-1,) + tuple(v.shape[2:]))  # noqa: E731
    return (x[:, offset:offset + size], fake_full[:, offset:offset + size],
            flat(x)[i_true.to(x.device)], flat(x_hat)[i_fake.to(x.device)])


class Adam:
    """torch's Adam(betas=(0.5, 0.9), eps=1e-8) with coupled weight decay
    and ``lr * gamma ** (count // steps_per_epoch)``; ``mu`` and ``nu`` per
    trainable leaf."""

    def __init__(self, params, opt):
        self.params = params
        self.opt = opt
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        o = self.opt
        b1, b2 = o["b1"], o["b2"]
        f32 = np.float32
        lr = float(f32(o["lr"]) * np.power(f32(o["gamma"]), f32(self.count // o["steps_per_epoch"])))
        self.count += 1
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g + o["weight_decay"] * p
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / (1 - b1 ** self.count)) / ((v / (1 - b2 ** self.count)).sqrt() + o["eps"])
            p.add_(upd, alpha=-lr)


class GanStep:
    """The step on ``nets`` (updated in place), with an ``Adam`` per net."""

    def __init__(self, nets, fs, tcfg, device):
        self.nets, self.fs, self.t = nets, fs, tcfg
        self.opts = {n: Adam([p for p in leaves(trainable(nets[n])) if p.is_floating_point()],
                             tcfg["adam"]) for n in NETS}
        for opt in self.opts.values():
            for p in opt.params:
                p.requires_grad_(True)
        self.vgg = vgg19_filters(device)

    def _grads(self, loss, net):
        params = self.opts[net].params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def forward_gen(self, gen, x, rng):
        g = first_stage.spectral_generator(gen)
        motion, mu, logvar = first_stage.encode(g["enc_motion"], x, self.fs, rng)
        return first_stage.decode(g, motion, x[:, 0], self.fs, x.shape[1] - 1), mu, logvar

    def disc_loss(self, which, real, fake):
        run = temp_disc if which == "dt" else patch_disc
        p_sn = nn.spectral_tree(self.nets[which])
        pred_fake, _ = run(p_sn, fake.detach())
        gp_w = self.t["gp_weight_dt"] if which == "dt" else 0.0
        real = real.detach().requires_grad_(gp_w > 0)
        pred_true, _ = run(p_sn, real)
        loss = 0.5 * (hinge(pred_fake, False) + hinge(pred_true, True))
        if gp_w > 0:
            (g,) = torch.autograd.grad(pred_true.sum(), real, create_graph=True)
            loss = loss + gp_w * torch.mean(g.reshape(g.shape[0], -1).square().sum(dim=1))
        return loss

    def __call__(self, x, rng):
        """One step on the videos ``x`` (B,T,S,S,3) with the JAX key ``rng``:
        the three losses (detached tensors), in the order dt, ds, generator."""
        t = self.t
        r_fwd, r_crop, _ = prng.split(rng, 3)
        plan = crop_plan(r_crop, x.shape[0], x.shape[1], t["mf_dt"], t["n_spatial"])
        with torch.no_grad():
            x_hat, _, _ = self.forward_gen(self.nets["gen"], x, r_fwd)
        x_true, x_fake, f_true, f_fake = crops(x, x_hat, plan)
        out = {}
        for which, real, fake in (("dt", x_true, x_fake), ("ds", f_true, f_fake)):
            loss = self.disc_loss(which, real, fake)
            self.opts[which].step(self._grads(loss, which))
            nn.refresh_u(self.nets[which])
            out[f"loss_d_{which}"] = loss.detach()
        x_hat, mu, logvar = self.forward_gen(self.nets["gen"], x, r_fwd)
        x_true, x_fake, _, f_fake = crops(x, x_hat, plan)
        with torch.no_grad():
            dt_sn = nn.spectral_tree(self.nets["dt"])
            ds_sn = nn.spectral_tree(self.nets["ds"])
            _, fmap_true = temp_disc(dt_sn, x_true)
        pred_dt, fmap_fake = temp_disc(dt_sn, x_fake)
        pred_ds, _ = patch_disc(ds_sn, f_fake)
        fmap = sum(torch.mean((a - b).abs()) for a, b in zip(fmap_fake, fmap_true)) / len(fmap_fake)
        flat = lambda v: v.reshape((-1,) + tuple(v.shape[2:]))  # noqa: E731
        kl = -0.5 * torch.mean((1 + logvar - mu.square() - torch.exp(logvar)).sum(dim=-1))
        loss = (-torch.mean(pred_dt) + fmap - torch.mean(pred_ds)
                + t["w_vgg"] * vgg_loss(self.vgg, flat(x[:, 1:]), flat(x_hat))
                + t["w_l1"] * torch.mean((x[:, 1:] - x_hat).abs()) + t["w_kl"] * kl)
        self.opts["gen"].step(self._grads(loss, "gen"))
        out["loss"] = loss.detach()
        return out
