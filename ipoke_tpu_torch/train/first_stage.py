"""First-stage cVAE-GAN training: three optimizers (generator, spatial and
temporal discriminator) updated in the reference's order (counterpart of
``ipoke_tpu/train/first_stage.py``):

  1. the temporal discriminator on a random mf_dt-frame crop: hinge loss
     plus an R1-style gradient penalty on the real crop (a double backward);
  2. the spatial discriminator on random frames;
  3. the generator: adversarial losses against the *updated*
     discriminators, their feature-map loss, VGG19 perceptual, L1 and KL.

Spectral norm is materialised inside each loss, with gradients through
``w / sigma`` and the power iteration; the stored ``u`` of both
discriminators is refreshed after their updates, the generator's never is
(as in the JAX package).  ``u`` takes no gradient, no update and no moments.
Gradients come from ``torch.autograd.grad``; the params are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.metrics.vgg import VGG19, vgg_loss
from ipoke_tpu_torch.models import discriminators as D
from ipoke_tpu_torch.models import first_stage
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec, TempDiscSpec
from ipoke_tpu_torch.models.first_stage import FirstStageSpec
from ipoke_tpu_torch.nn.blocks import materialize_spectral_norm, refresh_spectral_u
from ipoke_tpu_torch.nn.core import Policy
from ipoke_tpu_torch.train.losses import kl_divergence, l1
from ipoke_tpu_torch.train.second_stage import Optimizer, float_leaves, torch_adam
from ipoke_tpu_torch.utils import prng, profiling

NETS = ("gen", "ds", "dt")
REMAT_MODES = ("none", "outer", "decode", "both")


class GanTrainState(NamedTuple):
    step: int
    gen_params: dict
    ds_params: dict
    dt_params: dict
    gen_opt: list
    ds_opt: list
    dt_opt: list


def trainable(params):
    """``params`` without the spectral-norm vectors ``u``: the tree an
    optimizer runs over (its float leaves; JAX's ``_label_tree`` freezes
    ``u`` and the integer leaves)."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items() if k != "u"}
    if isinstance(params, (list, tuple)):
        return [trainable(v) for v in params]
    return params


def staircase(lr, gamma, steps_per_epoch):
    """``lr * gamma ** (count // steps_per_epoch)`` in f32, as JAX's schedule."""
    f32 = np.float32
    return lambda count: float(f32(lr) * np.power(f32(gamma), f32(count // steps_per_epoch)))


def make_gan_optimizer(lr, weight_decay=1e-5, gamma=0.98, steps_per_epoch=2000) -> Optimizer:
    """optax's ``add_decayed_weights(wd)`` -> ``scale_by_adam(0.5, 0.9)`` ->
    ``scale_by_learning_rate(staircase)``: torch's Adam(betas=(0.5, 0.9))
    with a per-epoch ExponentialLR, over ``trainable(params)``."""
    return Optimizer(torch_adam(staircase(lr, gamma, steps_per_epoch), weight_decay, b1=0.5, b2=0.9))


def init_gan_state(key, fs_spec: FirstStageSpec, ds_spec: PatchDiscSpec, dt_spec: TempDiscSpec,
                   lr=2e-4, weight_decay=1e-5, gamma=0.98, steps_per_epoch=2000, device=None):
    """(state, optimizers): the three nets from ``split(key, 3)`` in JAX's
    draws, ``u`` included, on ``device`` (the CUDA card by default); their
    trainable leaves require grad."""
    device = resolve_device(device)
    k1, k2, k3 = prng.split(key, 3)
    nets = {"gen": first_stage.init(k1, fs_spec, device, spectral_u=True),
            "ds": D.init_patch_disc(k2, ds_spec, device),
            "dt": D.init_temp_disc(k3, dt_spec, device)}
    opts = {n: make_gan_optimizer(lr, weight_decay, gamma, steps_per_epoch) for n in NETS}
    for p in nets.values():
        for leaf in float_leaves(trainable(p)):
            leaf.requires_grad_(True)
    state = GanTrainState(0, nets["gen"], nets["ds"], nets["dt"],
                          *(opts[n].init(trainable(nets[n])) for n in NETS))
    return state, opts


def _grads(loss, params):
    """d loss / d each trainable float leaf of ``params``, zeros where unused."""
    leaves = float_leaves(trainable(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _update(optimizer: Optimizer, opt_state, params, grads):
    leaves = float_leaves(trainable(params))
    with torch.no_grad():
        torch._foreach_add_(leaves, optimizer.update(grads, opt_state, leaves))


def crop_plan(key, b, t, mf_dt, n_spatial_examples):
    """The step's random crops from ``key``, drawn on the host as JAX draws
    them: the temporal offset (clamped as ``dynamic_slice`` clamps it), and
    ``n_spatial_examples`` indices into the B*T real and the B*(T-1) fake
    frames."""
    r1, r2, r3 = prng.split(key, 3)
    size = min(mf_dt, t)
    offset = int(prng.randint(r1, (), 0, max(1, t - mf_dt)))
    offset = min(max(offset, 0), t - size)
    return (offset, size, prng.randint(r2, (n_spatial_examples,), 0, b * t),
            prng.randint(r3, (n_spatial_examples,), 0, b * (t - 1)))


def crops(x, x_hat, plan):
    """(real crop, fake crop, real frames, fake frames) of ``plan``; the fake
    crop is cut from the start frame followed by ``x_hat``."""
    offset, size, i_true, i_fake = plan
    fake_full = torch.cat([x[:, :1], x_hat], dim=1)
    flat_true = x.reshape((-1,) + tuple(x.shape[2:]))
    flat_fake = x_hat.reshape((-1,) + tuple(x_hat.shape[2:]))
    return (x[:, offset:offset + size], fake_full[:, offset:offset + size],
            flat_true[i_true.to(x.device)], flat_fake[i_fake.to(x.device)])


class GanLosses:
    """The three losses of a stage-1 step (the closures of JAX's
    ``make_gan_train_step``); see :func:`make_gan_train_step` for the options."""

    def __init__(self, fs_spec: FirstStageSpec, ds_spec: PatchDiscSpec, dt_spec: TempDiscSpec,
                 w_vgg=10.0, w_l1=10.0, w_kl=1e-7, remat=False, vgg_chunks=1, disc_bf16=False,
                 vgg: VGG19 = None, forward_fn=None):
        remat = {False: "none", True: "both"}.get(remat, remat)
        if remat not in REMAT_MODES:
            raise ValueError(f"remat {remat!r} is not one of {REMAT_MODES}")
        self.fs_spec, self.ds_spec, self.dt_spec = fs_spec, ds_spec, dt_spec
        self.w_vgg, self.w_l1, self.w_kl = w_vgg, w_l1, w_kl
        self.remat, self.vgg_chunks, self.disc_bf16 = remat, vgg_chunks, disc_bf16
        self.vgg = vgg if vgg is not None else VGG19()
        self.forward_fn = forward_fn

    def _disc(self, apply, spec, params_sn, x):
        if self.disc_bf16:
            pred, fmaps = apply(Policy(torch.bfloat16).cast(params_sn), x.to(torch.bfloat16), spec)
            return pred.float(), [f.float() for f in fmaps]
        return apply(params_sn, x, spec)

    def temp_disc(self, params_sn, x):
        return self._disc(D.temp_disc_apply, self.dt_spec, params_sn, x)

    def patch_disc(self, params_sn, x):
        return self._disc(D.patch_disc_apply, self.ds_spec, params_sn, x)

    def forward_gen(self, gen_params, x, rng, batch=None):
        """(x_hat, mu, logvar) of the spectral-normed generator on the videos
        ``x``: ``first_stage.forward``, or ``forward_fn(params, batch, rng)``
        where one is given (``batch`` defaults to ``{"images": x}``)."""
        gen_sn = first_stage.materialize_spectral_norm(gen_params)
        if self.forward_fn is not None:
            batch = {"images": x} if batch is None else batch
            f = lambda p: self.forward_fn(p, batch, rng)  # noqa: E731
        else:
            f = lambda p: first_stage.forward(p, x, self.fs_spec, rng=rng,  # noqa: E731
                                              remat_decode=self.remat in ("decode", "both"))
        if self.remat in ("outer", "both") and torch.is_grad_enabled():
            return checkpoint(f, gen_sn, use_reentrant=False)
        return f(gen_sn)

    def vgg_loss(self, tgt, hat):
        k = self.vgg_chunks
        if k <= 1:
            return vgg_loss(self.vgg, tgt, hat)
        n = tgt.shape[0]
        if n % k:
            raise ValueError(f"vgg_chunks={k} must divide the {n} flattened frames "
                             "(batch * (frames - 1))")
        total = 0.0
        for a, b in zip(tgt.chunk(k), hat.chunk(k)):
            total = total + checkpoint(vgg_loss, self.vgg, a, b, use_reentrant=False)
        return total / k

    def disc_loss(self, which, params, real, fake):
        """(loss, gp) of the temporal (``which='dt'``) or spatial (``'ds'``)
        discriminator: hinge (or BCE) on the real and the detached fake input,
        plus its spec's gradient penalty on the real input when its weight is
        above 0 (else gp is 0); the spectral norm materialised inside."""
        run, spec = ((self.temp_disc, self.dt_spec) if which == "dt"
                     else (self.patch_disc, self.ds_spec))
        p_sn = materialize_spectral_norm(params)
        pred_fake, _ = run(p_sn, fake.detach())
        real = real.detach().requires_grad_(spec.gp_weight > 0)
        pred_true, _ = run(p_sn, real)
        loss = 0.5 * (D.disc_loss(pred_fake, False, spec.bce_loss)
                      + D.disc_loss(pred_true, True, spec.bce_loss))
        gp = torch.zeros((), device=loss.device)
        if spec.gp_weight > 0:
            gp = D.gradient_penalty(pred_true, real)
            loss = loss + spec.gp_weight * gp
        return loss, gp

    def gen_loss(self, gen_params, dt_params, ds_params, x, rng, plan, batch=None):
        """(loss, logs) of the generator against the given discriminators,
        which take no gradient; ``batch`` reaches a ``forward_fn``."""
        dt_spec, ds_spec = self.dt_spec, self.ds_spec
        x_hat, mu, logvar = self.forward_gen(gen_params, x, rng, batch)
        x_true, x_fake, _, f_fake = crops(x, x_hat, plan)
        with torch.no_grad():
            dt_sn = materialize_spectral_norm(dt_params)
            ds_sn = materialize_spectral_norm(ds_params)
            _, fmap_true = self.temp_disc(dt_sn, x_true)
        pred_fake_dt, fmap_fake = self.temp_disc(dt_sn, x_fake)
        loss_gen_dt = D.gen_loss(pred_fake_dt, dt_spec.bce_loss)
        loss_fmap = D.fmap_loss(fmap_fake, fmap_true)
        pred_fake_ds, _ = self.patch_disc(ds_sn, f_fake)
        loss_gen_ds = D.gen_loss(pred_fake_ds, ds_spec.bce_loss)
        flat = lambda v: v.reshape((-1,) + tuple(v.shape[2:]))  # noqa: E731
        loss_vgg = self.vgg_loss(flat(x[:, 1:]), flat(x_hat))
        loss_l1 = l1(x[:, 1:], x_hat)
        loss_kl = (torch.zeros((), device=x.device) if self.fs_spec.deterministic
                   else kl_divergence(mu, logvar))
        loss = (dt_spec.gen_weight * loss_gen_dt + dt_spec.fmap_weight * loss_fmap
                + ds_spec.gen_weight * loss_gen_ds
                + self.w_vgg * loss_vgg + self.w_l1 * loss_l1 + self.w_kl * loss_kl)
        return loss, {"loss": loss, "loss_g_t": loss_gen_dt, "loss_g_s": loss_gen_ds,
                      "loss_fmap_t": loss_fmap, "l_vgg": loss_vgg, "l_rec": loss_l1,
                      "l_kl": loss_kl}


def make_gan_train_step(fs_spec: FirstStageSpec, ds_spec: PatchDiscSpec, dt_spec: TempDiscSpec,
                        optimizers, w_vgg=10.0, w_l1=10.0, w_kl=1e-7, n_spatial_examples=16,
                        remat=False, vgg_chunks=1, disc_bf16=False, forward_fn=None):
    """``train_step(state, batch, rng) -> (state, metrics)``; ``rng`` a JAX
    key (``utils/prng``), batch['images'] (B, T, S, S, 3).

    ``forward_fn(gen_params_sn, batch, rng) -> (x_hat, mu, logvar)``, where
    given, is the generator's forward in place of ``first_stage.forward``
    (the ``poke_vae`` baseline's ``models/variants.poke_vae_forward``, which
    reads batch['poke'] too); ``remat`` "decode" does not reach into it.

    ``remat``: ``"outer"`` checkpoints the whole generator forward,
    ``"decode"`` each frame's SPADE decoder, ``"both"`` (or True) both,
    ``"none"`` (or False) neither.  ``vgg_chunks`` > 1: the perceptual loss
    as the mean of that many equal frame chunks, each checkpointed (the same
    value and gradients; one chunk's VGG activations live at a time).
    ``disc_bf16``: both discriminators run in bfloat16 on casts of the
    spectral-normed params; losses and penalties reduce in f32.  The keys
    ``r_fwd, r_crop, _ = split(rng, 3)`` are shared by the discriminators'
    pass and the generator's, as in the JAX package.  ``on_phase``, when
    given to ``train_step``, is called with "dt", "ds" and "gen" after each
    net's update (a benchmark records its timing events there).  The step
    and its phases are spans (``utils/profiling``): ``gan.step`` around
    ``gan.plan``, ``gan.gen_forward``, ``gan.dt``, ``gan.ds`` and ``gan.gen``."""
    losses = GanLosses(fs_spec, ds_spec, dt_spec, w_vgg, w_l1, w_kl, remat, vgg_chunks,
                       disc_bf16, forward_fn=forward_fn)
    mf_dt = dt_spec.sequence_length

    def train_step(state: GanTrainState, batch, rng, on_phase=lambda name: None):
        with profiling.span("gan.step"):
            return _train_step(state, batch, rng, on_phase)

    def _train_step(state, batch, rng, on_phase):
        x = batch["images"]
        with profiling.span("gan.plan"):
            r_fwd, r_crop, _ = prng.split(rng, 3)
            plan = crop_plan(r_crop, x.shape[0], x.shape[1], mf_dt, n_spatial_examples)
        with profiling.span("gan.gen_forward"):
            with torch.no_grad():   # the generator's output for the discriminator updates
                x_hat, _, _ = losses.forward_gen(state.gen_params, x, r_fwd, batch)
            x_true, x_fake, f_true, f_fake = crops(x, x_hat, plan)

        with profiling.span("gan.dt"):
            loss_dt, gp_dt = losses.disc_loss("dt", state.dt_params, x_true, x_fake)
            _update(optimizers["dt"], state.dt_opt, state.dt_params,
                    _grads(loss_dt, state.dt_params))
            refresh_spectral_u(state.dt_params)
        on_phase("dt")

        with profiling.span("gan.ds"):
            loss_ds, _ = losses.disc_loss("ds", state.ds_params, f_true, f_fake)
            _update(optimizers["ds"], state.ds_opt, state.ds_params,
                    _grads(loss_ds, state.ds_params))
            refresh_spectral_u(state.ds_params)
        on_phase("ds")

        with profiling.span("gan.gen"):
            loss_g, logs = losses.gen_loss(state.gen_params, state.dt_params, state.ds_params, x,
                                           r_fwd, plan, batch)
            _update(optimizers["gen"], state.gen_opt, state.gen_params,
                    _grads(loss_g, state.gen_params))
        on_phase("gen")
        metrics = {"loss_d_dt": loss_dt, "loss_gp_dt": gp_dt, "loss_d_ds": loss_ds, **logs}
        return state._replace(step=state.step + 1), {k: v.detach() for k, v in metrics.items()}

    train_step.losses = losses
    return train_step
