"""Conditioning-tower trainers (counterpart of ``ipoke_tpu/train/encoders.py``).

Image AE (the reference's ConvAEModel): a variational (or deterministic)
conv AE on single frames, the *last* frame of each video.  Its loss is the
NLL under a learned global ``logvar`` of L1 plus the VGG19 perceptual loss,
the KL of the encoder's heads, and a PatchGAN term whose weight adapts: the
ratio of the NLL's and the adversarial loss's gradient norms at the
decoder's last conv (``d_weight``, clipped to [0, 1e4], no gradient).  The
discriminator (hinge loss, optional gradient penalty) is updated first, on a
reconstruction without gradient, then the AE against the updated one.

Poke AE (the reference's ConvPokeAE): a deterministic AE from the sparse
poke (or the flow, ``flow_ae``; with the start frame stacked on,
``poke_and_image``) to the dense flow, under the same NLL of L1 plus VGG19
(the two flow channels padded with a zero third).

Both optimizers are optax's ``adam(lr, 0.5, 0.9)`` under ``multi_transform``
with the spectral-norm ``u`` frozen: the port's ``torch._foreach_*`` Adam
over the float leaves without ``u``.  After each update every ``u`` takes
one power iteration (``refresh_spectral_u``).  Gradients come from
``torch.autograd.grad``; the params are updated in place.

``*_ckpt_tree`` give a state in JAX's ``AETrainState`` / ``PokeAEState``
npz layout, optax's state included (``inner_states`` of ``train`` and
``freeze``; the moments' ``u`` masked as empty), so JAX's ``restore_like``
reads it; ``restore_*`` read such a tree, JAX's or the port's, back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.ckpt.jax_bridge import _convert, _export, bridge_wrapper, unbridge_wrapper
from ipoke_tpu_torch.ckpt.optax_layout import from_optax, to_optax
from ipoke_tpu_torch.metrics.vgg import VGG19, vgg_loss
from ipoke_tpu_torch.models import discriminators as D
from ipoke_tpu_torch.models import encoders
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.nn import blocks
from ipoke_tpu_torch.train.first_stage import _grads, _update, trainable
from ipoke_tpu_torch.train.second_stage import Optimizer, adam, float_leaves
from ipoke_tpu_torch.utils import prng


class AETrainState(NamedTuple):
    step: int
    params: dict          # {'model': wrapper params (u included), 'logvar': scalar}
    disc_params: dict
    opt_state: list
    disc_opt_state: list


class PokeAEState(NamedTuple):
    step: int
    params: dict
    opt_state: list


def kl_conv(mu, logvar):
    """kl_conv (the reference's utils/losses.py): summed over the
    flattened dims, averaged over the batch."""
    mu2 = mu.reshape(mu.shape[0], -1)
    lv = logvar.reshape(logvar.shape[0], -1)
    return torch.mean(0.5 * torch.sum(mu2 ** 2 + torch.exp(lv) - 1.0 - lv, dim=-1))


def make_ae_optimizer(lr=1e-4) -> Optimizer:
    """optax's ``adam(lr, b1=0.5, b2=0.9)`` over ``trainable(params)``."""
    return adam(lr, 0.5, 0.9, masked=True)


def _requires_grad(tree):
    for leaf in float_leaves(trainable(tree)):
        leaf.requires_grad_(True)
    return tree


def init_image_ae(key, spec: WrapperSpec, disc_spec: PatchDiscSpec, lr=1e-4, device=None):
    """(state, optimizers): the wrapper (both halves, ``u`` included) from
    the first of ``split(key)`` and the patch discriminator from the second,
    JAX's draws, on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    k1, k2 = prng.split(key)
    params = _requires_grad({
        "model": encoders.init_wrapper(k1, spec, device, train=True),
        "logvar": torch.zeros((), device=device)})
    disc = _requires_grad(D.init_patch_disc(k2, disc_spec, device))
    opts = {"gen": make_ae_optimizer(lr), "disc": make_ae_optimizer(lr)}
    state = AETrainState(0, params, disc, opts["gen"].init(trainable(params)),
                         opts["disc"].init(trainable(disc)))
    return state, opts


def init_poke_ae(key, spec: WrapperSpec, lr=1e-4, device=None):
    """(state, optimizer): the wrapper drawn from ``key`` itself, as JAX's."""
    device = resolve_device(device)
    params = _requires_grad({
        "model": encoders.init_wrapper(key, spec, device, train=True),
        "logvar": torch.zeros((), device=device)})
    opt = make_ae_optimizer(lr)
    return PokeAEState(0, params, opt.init(trainable(params))), opt


def _nll(rec_loss, logvar):
    nll = rec_loss / torch.exp(logvar) + logvar
    return torch.sum(nll) / nll.shape[0]


class ImageAELosses:
    """The closures of JAX's ``make_image_ae_step``."""

    def __init__(self, spec: WrapperSpec, disc_spec: PatchDiscSpec, kl_weight=1e-6,
                 disc_active=True, vgg: VGG19 = None):
        self.spec, self.disc_spec = spec, disc_spec
        self.enc_spec, self.dec_spec = spec.encoder_spec, spec.decoder_spec
        self.kl_weight, self.disc_active = kl_weight, disc_active
        self.vgg = vgg if vgg is not None else VGG19()

    def reconstruct(self, model_params, x, rng):
        """(rec, mean, logstd) of the spectral-normed wrapper; the decoder
        reads the bottleneck feature, or the mean when variational."""
        sn = encoders.materialize_spectral_norm(model_params)
        out, mean, logstd = encoders.conv_encoder_apply(sn["encoder"], x, self.enc_spec, rng=rng)
        in_dec = mean if self.enc_spec.variational else out
        return encoders.conv_decoder_apply(sn["decoder"], [in_dec], self.dec_spec), mean, logstd

    def nll_terms(self, x, rec, logvar):
        rec_loss = torch.abs(x - rec) + vgg_loss(self.vgg, x, rec)   # perc_weight 1
        return _nll(rec_loss, logvar), torch.mean(rec_loss)

    def disc_loss(self, disc_params, x, rec):
        """Hinge loss on the real frames and the detached reconstruction,
        plus ``gp_weight`` times the gradient penalty on the real ones."""
        sn = blocks.materialize_spectral_norm(disc_params)
        gp = self.disc_spec.gp_weight > 0
        real = x.detach().requires_grad_(gp)
        pred_true, _ = D.patch_disc_apply(sn, real, self.disc_spec)
        pred_fake, _ = D.patch_disc_apply(sn, rec.detach(), self.disc_spec)
        loss = 0.5 * (D.disc_loss(pred_true, True) + D.disc_loss(pred_fake, False))
        if gp:
            loss = loss + self.disc_spec.gp_weight * D.gradient_penalty(pred_true, real)
        return loss

    def gen_loss(self, params, disc_params, x, rng):
        """(loss, logs) against the given discriminator, which takes no
        gradient.  ``d_weight`` from the gradients of the NLL and of the
        adversarial loss at ``decoder.out_conv.conv.w`` on this graph."""
        rec, mean, logstd = self.reconstruct(params["model"], x, rng)
        nll, rec_mean = self.nll_terms(x, rec, params["logvar"])
        kl = (kl_conv(mean, logstd) if self.enc_spec.variational
              else torch.zeros((), device=x.device))
        with torch.no_grad():
            dsn = blocks.materialize_spectral_norm(disc_params)
        pred_fake, _ = D.patch_disc_apply(dsn, rec, self.disc_spec)
        g_loss = D.gen_loss(pred_fake)
        if self.disc_active:
            last_w = params["model"]["decoder"]["out_conv"]["conv"]["w"]
            (g_nll,) = torch.autograd.grad(nll, last_w, retain_graph=True)
            (g_adv,) = torch.autograd.grad(g_loss, last_w, retain_graph=True)
            d_weight = (torch.linalg.vector_norm(g_nll)
                        / (torch.linalg.vector_norm(g_adv) + 1e-4)).clamp(0.0, 1e4).detach()
        else:
            d_weight = torch.zeros((), device=x.device)
        loss = nll + self.kl_weight * kl + d_weight * g_loss
        return loss, {"loss": loss, "nll_loss": nll, "kl_loss": kl, "rec_loss": rec_mean,
                      "g_loss": g_loss, "d_weight": d_weight,
                      "logvar": params["logvar"].detach().clone()}


def make_image_ae_step(spec: WrapperSpec, disc_spec: PatchDiscSpec, optimizers,
                       kl_weight=1e-6, disc_active=True, vgg: VGG19 = None):
    """``train_step(state, batch, rng) -> (state, logs)``; ``rng`` a JAX key
    (``utils/prng``), ``batch['images']`` (B, T, S, S, 3).  ``on_phase``,
    when given to ``train_step``, is called with "disc" and "gen" after each
    net's update (a benchmark records its timing events there)."""
    losses = ImageAELosses(spec, disc_spec, kl_weight, disc_active, vgg)

    def train_step(state: AETrainState, batch, rng, on_phase=lambda name: None):
        x = batch["images"][:, -1]     # the reference trains on the last frame
        r1, _ = prng.split(rng)
        with torch.no_grad():
            rec, _, _ = losses.reconstruct(state.params["model"], x, r1)
        d_loss = losses.disc_loss(state.disc_params, x, rec)
        _update(optimizers["disc"], state.disc_opt_state, state.disc_params,
                _grads(d_loss, state.disc_params))
        blocks.refresh_spectral_u(state.disc_params)
        on_phase("disc")

        loss, logs = losses.gen_loss(state.params, state.disc_params, x, r1)
        _update(optimizers["gen"], state.opt_state, state.params, _grads(loss, state.params))
        encoders.refresh_spectral_u(state.params["model"])
        on_phase("gen")
        logs["d_loss"] = d_loss
        return state._replace(step=state.step + 1), {k: v.detach() for k, v in logs.items()}

    train_step.losses = losses
    return train_step


def poke_ae_loss(params, batch, spec: WrapperSpec, vgg: VGG19, flow_ae=False):
    """(nll, logs) of JAX's ``make_poke_ae_step`` loss."""
    poke = batch["flow"] if flow_ae else batch["poke"]
    if spec.poke_and_image:
        poke = torch.cat([poke, batch["images"][:, 0]], dim=-1)
    flow = batch["flow"]
    rec = encoders.wrapper_apply(encoders.materialize_spectral_norm(params["model"]), poke, spec)
    zeros = torch.zeros(tuple(flow.shape[:-1]) + (1,), dtype=flow.dtype, device=flow.device)
    p_loss = vgg_loss(vgg, torch.cat([flow, zeros], -1), torch.cat([rec, zeros], -1))
    rec_loss = torch.abs(flow - rec) + p_loss
    nll = _nll(rec_loss, params["logvar"])
    return nll, {"nll_loss": nll, "rec_loss": torch.mean(rec_loss),
                 "logvar": params["logvar"].detach().clone()}


def make_poke_ae_step(spec: WrapperSpec, optimizer, flow_ae=False, vgg: VGG19 = None):
    """``train_step(state, batch, rng=None) -> (state, logs)``; the batch
    holds 'poke', 'flow' and (``poke_and_image``) 'images'."""
    vgg = vgg if vgg is not None else VGG19()

    def train_step(state: PokeAEState, batch, rng=None):
        nll, logs = poke_ae_loss(state.params, batch, spec, vgg, flow_ae)
        _update(optimizer, state.opt_state, state.params, _grads(nll, state.params))
        encoders.refresh_spectral_u(state.params["model"])
        return state._replace(step=state.step + 1), {k: v.detach() for k, v in logs.items()}

    train_step.vgg = vgg
    return train_step


# ---------------------------------------------------------------------------
# checkpoints in JAX's AETrainState / PokeAEState layout
# ---------------------------------------------------------------------------

def _export_params(params, is_wrapper):
    if is_wrapper:
        return {"model": unbridge_wrapper(params["model"]),
                "logvar": params["logvar"].detach().cpu().numpy()}
    return _export(params)


# the layout of make_ae_optimizer's state, which does not depend on the lr
_AE_LAYOUT = make_ae_optimizer()


def _optax_state(params, opt_state, is_wrapper):
    """The port's Adam state as optax's ``multi_transform`` state."""
    return to_optax(_AE_LAYOUT, opt_state, params, lambda t: _export_params(t, is_wrapper))


def image_ae_ckpt_tree(state: AETrainState):
    """The state as JAX's ``_ckpt_tree`` holds an ``AETrainState``."""
    return {"step": np.asarray(state.step, np.int32),
            "params": _export_params(state.params, True),
            "disc_params": _export(state.disc_params),
            "opt_state": _optax_state(state.params, state.opt_state, True),
            "disc_opt_state": _optax_state(state.disc_params, state.disc_opt_state, False)}


def poke_ae_ckpt_tree(state: PokeAEState):
    """The state as JAX's ``_ckpt_tree`` holds a ``PokeAEState``."""
    return {"step": np.asarray(state.step, np.int32),
            "params": _export_params(state.params, True),
            "opt_state": _optax_state(state.params, state.opt_state, True)}


def bridge_ae_params(tree, device=None):
    """``{'model': wrapper, 'logvar'}`` of a JAX tree in the port's layout."""
    device = resolve_device(device)
    return {"model": bridge_wrapper(tree["model"], device),
            "logvar": torch.tensor(float(tree["logvar"]), device=device)}


def _restore_opt(params, opt, is_wrapper, device):
    bridge = ((lambda t: {"model": bridge_wrapper(t["model"], device, keep_u=False),
                          "logvar": torch.tensor(float(t["logvar"]), device=device)})
              if is_wrapper else (lambda t: _convert(t, device)))
    return from_optax(_AE_LAYOUT, opt, params, bridge)


def restore_image_ae(tree, device=None) -> AETrainState:
    """An ``AETrainState`` tree (JAX's npz, or ``image_ae_ckpt_tree``) as
    the port's state, trainable leaves requiring grad."""
    device = resolve_device(device)
    params = _requires_grad(bridge_ae_params(tree["params"], device))
    disc = _requires_grad(_convert(tree["disc_params"], device, keep_u=True))
    return AETrainState(int(tree["step"]), params, disc,
                        _restore_opt(params, tree["opt_state"], True, device),
                        _restore_opt(disc, tree["disc_opt_state"], False, device))


def restore_poke_ae(tree, device=None) -> PokeAEState:
    """A ``PokeAEState`` tree as the port's state."""
    device = resolve_device(device)
    params = _requires_grad(bridge_ae_params(tree["params"], device))
    return PokeAEState(int(tree["step"]), params,
                       _restore_opt(params, tree["opt_state"], True, device))
