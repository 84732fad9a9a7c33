"""The port's stage-1 generator, train step and trainer against the JAX
package on the CPU.

* ``first_stage.forward`` with a key (the reparameterised draw) on the
  spectral-normed generator, and the generator's loss with its gradients
  against ``jax.value_and_grad`` of JAX's ``gen_loss_fn`` written from the
  JAX package's public functions: every log and every gradient leaf within
  2e-4·(1+max|ref|).
* The step: ``vgg_chunks=2`` gives the plain step's gradients, remat
  "both" the plain generator gradients, ``disc_bf16``'s losses land near
  the f32 ones; one step updates the three nets in JAX's order, refreshes
  the discriminators' ``u`` from their updated weights and keeps the
  generator's.
* The trainer's CLI: tests/test_torch_gan_trainer.py.
* ``slow`` (outside tier-1, ~75 s here cold, most of it compiling JAX's step):
  one whole ``train_step`` against JAX's jitted ``make_gan_train_step`` with
  the same key, both with an optimizer whose updates are the gradients.

The test size is ``torch_port_util.GAN_FS``: at a decoder width of 16 in
place of 8, JAX's own f32 gradients of the generator lie 2.9e-4 (relative
to 1 + max|g|) from the port's float64 ones while the port's f32 ones lie
6.8e-6 away, so that width measures JAX's rounding, not the port.  oneDNN is
off for the port, as in tests/test_torch_gan.py."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.metrics import vgg as jvgg
from ipoke_tpu.models import discriminators as JD
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn.blocks import materialize_spectral_norm as jmaterialize
from ipoke_tpu.train import first_stage as jtfs
from ipoke_tpu.train.losses import kl_divergence, l1
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_gan_params
from ipoke_tpu_torch.models import discriminators as D
from ipoke_tpu_torch.models import first_stage as pfs
from ipoke_tpu_torch.nn.core import spectral_normalize
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.train.second_stage import Optimizer, float_leaves
from ipoke_tpu_torch.utils import prng
from torch_port_util import (CPU, GAN_BATCH, GAN_FS, clone_tree, flatten, gan_specs, jit_o0, np_tree,
                             random_like, t)

TOL = 2e-4
FWD_KEY, STEP_KEY = 5, 21
N_SPATIAL = 2
JFS_SPEC, JDS, JDT = gan_specs(jfs, JD)
FS_SPEC, DS, DT = gan_specs(pfs, D)


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@jit_o0
def jax_forward(gen, x, key):
    """JAX's forward of the spectral-normed generator with a key."""
    return jfs.forward(jmaterialize(gen), x, JFS_SPEC, rng=key)


def _max_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (1 + np.abs(want).max()))


@pytest.fixture(scope="module")
def case():
    """Numpy-drawn nets (JAX layout) and a batch, with JAX's forward and its
    generator loss (``gen_loss_fn`` of ``make_gan_train_step``) and
    gradients, the keys split as its step splits them."""
    key = jax.random.PRNGKey(0)
    nets = {"gen_params": random_like(jax.eval_shape(lambda: jfs.init(key, JFS_SPEC)), 11),
            "ds_params": random_like(jax.eval_shape(lambda: JD.init_patch_disc(key, JDS)), 12),
            "dt_params": random_like(jax.eval_shape(lambda: JD.init_temp_disc(key, JDT)), 13)}
    images = np.random.default_rng(14).uniform(-1, 1, (GAN_BATCH, GAN_FS["max_frames"], 32, 32, 3))
    images = images.astype(np.float32)
    r_fwd, r_crop, _ = jax.random.split(jax.random.PRNGKey(STEP_KEY), 3)

    def gen_loss(gen, dt, ds, x):
        x_hat, mu, logvar = jfs.forward(jmaterialize(gen), x, JFS_SPEC, rng=r_fwd)
        t_ = x.shape[1]
        r1, r2, r3 = jax.random.split(r_crop, 3)
        offset = jax.random.randint(r1, (), 0, max(1, t_ - JDT.sequence_length))
        size = min(JDT.sequence_length, t_)
        x_true = jax.lax.dynamic_slice_in_dim(x, offset, size, axis=1)
        x_fake = jax.lax.dynamic_slice_in_dim(jnp.concatenate([x[:, :1], x_hat], axis=1),
                                              offset, size, axis=1)
        flat_fake = x_hat.reshape(-1, *x_hat.shape[2:])
        f_fake = flat_fake[jax.random.randint(r3, (N_SPATIAL,), 0, flat_fake.shape[0])]
        dt_sn, ds_sn = jmaterialize(dt), jmaterialize(ds)
        pred_fake_dt, fmap_fake = JD.temp_disc_apply(dt_sn, x_fake, JDT)
        _, fmap_true = JD.temp_disc_apply(dt_sn, x_true, JDT)
        logs = {"loss_g_t": JD.gen_loss(pred_fake_dt), "loss_fmap_t": JD.fmap_loss(fmap_fake, fmap_true),
                "loss_g_s": JD.gen_loss(JD.patch_disc_apply(ds_sn, f_fake, JDS)[0]),
                "l_vgg": jvgg.vgg_loss(x[:, 1:].reshape(-1, *x.shape[2:]), flat_fake),
                "l_rec": l1(x[:, 1:], x_hat), "l_kl": kl_divergence(mu, logvar)}
        loss = (logs["loss_g_t"] + logs["loss_fmap_t"] + logs["loss_g_s"] + 10.0 * logs["l_vgg"]
                + 10.0 * logs["l_rec"] + 1e-7 * logs["l_kl"])
        return loss, dict(logs, loss=loss)

    @jit_o0
    def reference(nets, x):
        (_, logs), grads = jax.value_and_grad(gen_loss, has_aux=True)(
            nets["gen_params"], nets["dt_params"], nets["ds_params"], x)
        return logs, grads

    logs, grads = reference(nets, jnp.asarray(images))
    fwd = jax_forward(nets["gen_params"], jnp.asarray(images), jax.random.PRNGKey(FWD_KEY))
    return nets, images, logs, grads, fwd


def _port_nets(nets):
    out = bridge_gan_params(nets, device=CPU)
    for p in out.values():
        for leaf in float_leaves(tfs.trainable(p)):
            leaf.requires_grad_(True)
    return out


def test_forward_with_a_key_matches_jax(case):
    nets, images, _, _, fwd = case
    gen = _port_nets(nets)["gen_params"]
    with torch.no_grad():
        got = pfs.forward(pfs.materialize_spectral_norm(gen), t(images), FS_SPEC,
                          rng=prng.prng_key(FWD_KEY))
        _, mu, _ = pfs.forward(gen, t(images), FS_SPEC)   # without a key: z = mu
    assert got[0].shape == (GAN_BATCH, GAN_FS["max_frames"] - 1, 32, 32, 3)
    for g, w in zip(got, fwd):
        assert _max_err(g, w) <= TOL
    with torch.no_grad():
        from_mu = pfs.decode(pfs.materialize_spectral_norm(gen), mu, t(images)[:, 0], FS_SPEC, 2)
    assert float((got[0] - from_mu).abs().max()) > 1e-3   # the draw is in play


def test_gen_loss_and_gradients_match_jax(case):
    nets, images, logs, grads, _ = case
    port = _port_nets(nets)
    losses = tfs.GanLosses(FS_SPEC, DS, DT)
    r_fwd, r_crop, _ = prng.split(prng.prng_key(STEP_KEY), 3)
    plan = tfs.crop_plan(r_crop, GAN_BATCH, GAN_FS["max_frames"], DT.sequence_length, N_SPATIAL)
    loss, got_logs = losses.gen_loss(port["gen_params"], port["dt_params"], port["ds_params"],
                                     t(images), r_fwd, plan)
    assert got_logs.keys() == logs.keys()
    for k, v in logs.items():
        assert abs(float(got_logs[k]) - float(v)) <= TOL * (1 + abs(float(v))), (k, float(got_logs[k]), float(v))
    leaves = float_leaves(tfs.trainable(port["gen_params"]))
    got = dict(zip(flatten(tfs.trainable(port["gen_params"])), torch.autograd.grad(loss, leaves)))
    want = flatten(tfs.trainable(bridge_gan_params({"gen_params": np_tree(grads)}, CPU)["gen_params"]))
    assert got.keys() == want.keys() and len(got) > 50
    errs = {k: float((g - want[k]).abs().max() / (1 + want[k].abs().max())) for k, g in got.items()}
    assert max(errs.values()) <= TOL, max(errs.items(), key=lambda kv: kv[1])


class _GradsAsUpdates:
    """An optimizer transform whose updates are the gradients: after a step,
    new - old is each leaf's gradient."""
    name = "grads"

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        return [u.clone() for u in updates]


def _step_grads(nets, images, **kw):
    """Per net, new - old of every trainable leaf after one port step with
    updates = gradients, and the step's metrics."""
    port = _port_nets(nets)
    opts = {n: Optimizer([_GradsAsUpdates()]) for n in tfs.NETS}
    state = tfs.GanTrainState(0, port["gen_params"], port["ds_params"], port["dt_params"],
                              *(opts[n].init(tfs.trainable(port[f"{n}_params"])) for n in tfs.NETS))
    start = {n: flatten(clone_tree(tfs.trainable(port[f"{n}_params"]))) for n in tfs.NETS}
    step = tfs.make_gan_train_step(FS_SPEC, DS, DT, opts, n_spatial_examples=N_SPATIAL, **kw)
    state, metrics = step(state, {"images": t(images)}, prng.prng_key(STEP_KEY))
    return state, {n: {k: v.detach() - start[n][k] for k, v in
                       flatten(tfs.trainable(getattr(state, f"{n}_params"))).items()}
                   for n in tfs.NETS}, metrics


@pytest.fixture(scope="module")
def plain_step(case):
    return _step_grads(case[0], case[1])


def test_vgg_chunks_give_the_plain_step(case, plain_step):
    _, plain, plain_metrics = plain_step
    _, got, metrics = _step_grads(case[0], case[1], vgg_chunks=2)
    for n in tfs.NETS:
        for k, g in got[n].items():
            w = plain[n][k]
            assert float((g - w).abs().max() / (1 + w.abs().max())) <= 1e-5, (n, k)
    for k, v in plain_metrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * (1 + abs(float(v))), k
    with pytest.raises(ValueError, match="must divide"):   # B * (T - 1) = 4 frames
        tfs.GanLosses(FS_SPEC, DS, DT, vgg_chunks=3).vgg_loss(t(case[1][:, 1:].reshape(-1, 32, 32, 3)),
                                                               t(case[1][:, 1:].reshape(-1, 32, 32, 3)))


def _gen_grads(nets, images, remat="none"):
    r_fwd, r_crop, _ = prng.split(prng.prng_key(STEP_KEY), 3)
    plan = tfs.crop_plan(r_crop, GAN_BATCH, GAN_FS["max_frames"], DT.sequence_length, N_SPATIAL)
    port = _port_nets(nets)
    loss, _ = tfs.GanLosses(FS_SPEC, DS, DT, remat=remat).gen_loss(
        port["gen_params"], port["dt_params"], port["ds_params"], t(images), r_fwd, plan)
    return loss.detach(), torch.autograd.grad(loss, float_leaves(tfs.trainable(port["gen_params"])))


def test_remat_gives_the_plain_generator_gradients(case):
    """Remat "both" (the whole generator forward and each frame's decoder
    checkpointed) changes only the generator's forward: its loss and
    gradients equal the plain ones."""
    plain_loss, plain = _gen_grads(case[0], case[1])
    loss, grads = _gen_grads(case[0], case[1], remat="both")
    assert abs(float(loss) - float(plain_loss)) <= 1e-6 * (1 + abs(float(plain_loss)))
    for g, w in zip(grads, plain):
        assert float((g - w).abs().max() / (1 + w.abs().max())) <= 1e-5


def test_step_updates_in_jax_order(case, plain_step):
    """The discriminators' u refreshed from their updated weights (one power
    iteration from the old u), the generator's u as it was; every loss finite."""
    nets, _, _, _, _ = case
    state, grads, metrics = plain_step
    start = _port_nets(nets)
    assert state.step == 1
    assert set(metrics) == {"loss_d_dt", "loss_gp_dt", "loss_d_ds", "loss", "loss_g_t",
                            "loss_g_s", "loss_fmap_t", "l_vgg", "l_rec", "l_kl"}
    assert all(np.isfinite(float(v)) for v in metrics.values()) and float(metrics["loss_gp_dt"]) > 0
    for n in tfs.NETS:
        assert sum(float(g.abs().max()) > 0 for g in grads[n].values()) > len(grads[n]) // 2, n
        now, then = flatten(getattr(state, f"{n}_params")), flatten(start[f"{n}_params"])
        for k in (k for k in now if k.endswith("/u")):
            if n == "gen":
                assert torch.equal(now[k], then[k]), k
                continue
            w = now[k[:-1] + "w"].detach()
            _, want = spectral_normalize(w, then[k])
            assert torch.allclose(now[k], want, atol=1e-6), k



def test_disc_bf16_losses_run_close(case):
    """``disc_bf16`` (both discriminators in bfloat16 on casts of the
    spectral-normed params): each discriminator's loss, the temporal one's
    with its gradient penalty, lands near the f32 one (JAX's own test's
    tolerance: rtol 0.1, atol 0.05); the gradients stay f32 and finite."""
    nets, images, _, _, _ = case
    port = _port_nets(nets)
    x = t(images)
    real = {"dt": x[:, :DT.sequence_length], "ds": x[:, 0]}
    fake = {k: (0.5 * v).flip(0) for k, v in real.items()}
    for which in ("dt", "ds"):
        got, _ = tfs.GanLosses(FS_SPEC, DS, DT, disc_bf16=True).disc_loss(
            which, port[f"{which}_params"], real[which], fake[which])
        want, _ = tfs.GanLosses(FS_SPEC, DS, DT).disc_loss(
            which, port[f"{which}_params"], real[which], fake[which])
        assert abs(float(got) - float(want)) <= 0.05 + 0.1 * abs(float(want)), which
    # the f32 params' gradients through the bf16 casts (the spatial disc: the
    # temporal one's double backward in bf16 takes ~10 s on this CPU)
    grads = torch.autograd.grad(got, float_leaves(tfs.trainable(port["ds_params"])))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.slow
def test_train_step_matches_jax_jitted_step(case):
    """One whole step against JAX's jitted ``make_gan_train_step`` (its u
    frozen as ``make_gan_optimizer`` freezes them): every gradient leaf of
    the three nets, the refreshed u and every metric within 2e-4·(1+|ref|)."""
    nets, images, _, _, _ = case

    def grads_as_updates(params):
        return optax.multi_transform(
            {"train": optax.GradientTransformation(lambda p: optax.EmptyState(),
                                                   lambda g, s, p=None: (g, s)),
             "freeze": optax.set_to_zero()}, jtfs._label_tree(params))

    opts = {n: grads_as_updates(nets[f"{n}_params"]) for n in tfs.NETS}
    jstate = jtfs.GanTrainState(jnp.zeros((), jnp.int32), nets["gen_params"], nets["ds_params"],
                                nets["dt_params"], *(opts[n].init(nets[f"{n}_params"]) for n in tfs.NETS))
    step = jax.jit(jtfs.make_gan_train_step(JFS_SPEC, JDS, JDT, opts, n_spatial_examples=N_SPATIAL))
    new, metrics = step(jstate, {"images": jnp.asarray(images)}, jax.random.PRNGKey(STEP_KEY))
    state, got, got_metrics = _step_grads(nets, images)
    start = bridge_gan_params(nets, device=CPU)
    after = bridge_gan_params(np_tree({f"{n}_params": getattr(new, f"{n}_params") for n in tfs.NETS}), CPU)
    for n in tfs.NETS:
        want = {k: v - flatten(start[f"{n}_params"])[k] for k, v in flatten(after[f"{n}_params"]).items()}
        for k, g in got[n].items():
            assert float((g - want[k]).abs().max() / (1 + want[k].abs().max())) <= TOL, (n, k)
        now = flatten(getattr(state, f"{n}_params"))
        for k in (k for k in want if k.endswith("/u")):
            assert float((now[k] - flatten(after[f"{n}_params"])[k]).abs().max()) <= 1e-6, (n, k)
    for k, v in metrics.items():
        assert abs(float(got_metrics[k]) - float(v)) <= TOL * (1 + abs(float(v))), k
