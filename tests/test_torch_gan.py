"""The port's stage-1 GAN pieces against the JAX package on the CPU.

* ``spectral_normalize`` on OIHW, transpose-conv and OIDHW kernels: w/sigma
  and the new u within 1e-6, the gradient of a random projection of w/sigma
  with respect to w and u within 2e-4·(1+max|g_ref|) of ``jax.grad``.
* ``prng.randint`` bitwise, on spans that are and are not powers of two and
  on the crop's ``(0, max(1, t - mf_dt))``; ``crop_plan`` draws JAX's crops.
* ``patch_disc_apply``, ``temp_disc_apply`` (predictions and feature maps),
  ``vgg_loss``, and each discriminator's loss with its gradients (the
  temporal one with its gradient penalty; ``jax.value_and_grad`` of the loss
  written from the JAX package's public functions, as its train step writes
  it): within 2e-4·(1+max|ref|); the hinge and BCE losses and the
  feature-map loss.
* ``make_gan_optimizer``: three steps on the same gradients across an epoch
  boundary of the staircase, params within 1e-6, ``u`` untouched.
* ``init_gan_state``: tests/test_torch_gan_init.py.

Params are numpy draws of JAX's tree shapes (``torch_port_util.random_like``)
bridged into both packages.  The JAX references come from one jitted
function (~20 s to compile here) and one for the optimizer.  oneDNN is off
for the port: its f32 convolutions on the CPU carry ~2e-3 relative error in
the VGG's gradients (against float64), which the port's own convolutions do
not."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.metrics import vgg as jvgg
from ipoke_tpu.models import discriminators as JD
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn import core as jcore
from ipoke_tpu.nn.blocks import materialize_spectral_norm as jmaterialize
from ipoke_tpu.train import first_stage as jtfs
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_gan_params
from ipoke_tpu_torch.metrics import vgg
from ipoke_tpu_torch.models import discriminators as D
from ipoke_tpu_torch.models import first_stage as pfs
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.nn.blocks import materialize_spectral_norm
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.train.second_stage import float_leaves
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, GAN_BATCH, flatten, gan_specs, np_tree, random_like, t

TOL = 2e-4          # the slice's f32 tolerance, relative to 1 + max|ref|
PARAM_TOL = 1e-6
S = 32


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / (1 + np.abs(want).max()))
    assert err <= tol, err
    return err


def _grad_errors(got, want):
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    return {k: float((g - want[k]).abs().max() / (1 + want[k].abs().max())) for k, g in got.items()}


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shape", [("conv", (3, 3, 5, 7)), ("transposed", (3, 3, 6, 4)),
                                        ("conv3d", (3, 3, 3, 4, 6))])
def test_spectral_normalize_matches_jax(kind, shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    w = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape[-1]).astype(np.float32)
    u /= np.linalg.norm(u)
    proj = rng.standard_normal(shape).astype(np.float32)

    def jf(w, u):
        w_sn, _ = jcore.spectral_normalize(w, u)
        return jnp.sum(w_sn * proj)

    (jw, ju) = jax.jit(jcore.spectral_normalize)(jnp.asarray(w), jnp.asarray(u))
    gw, gu = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(u))
    transposed = kind == "transposed"
    pw = core.from_hwio(t(w), transposed).requires_grad_(True)
    pu = t(u).requires_grad_(True)
    w_sn, u_new = core.spectral_normalize(pw, pu, out_axis=1 if transposed else 0)
    assert not u_new.requires_grad
    _close(core.to_hwio(w_sn, transposed).detach(), jw, 1e-6)
    _close(u_new, ju, 1e-6)
    got_w, got_u = torch.autograd.grad((w_sn * core.from_hwio(t(proj), transposed)).sum(), (pw, pu))
    _close(core.to_hwio(got_w, transposed), gw)
    _close(got_u, gu)
    assert float(np.abs(np.asarray(gu)).max()) > 1e-3   # the gradient reaches u


# ---------------------------------------------------------------------------
# randint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi,shape", [
    (0, 1, ()), (0, 7, (16,)), (0, 8, (16,)), (3, 100, (5, 3)), (0, 2**16, (9,)),
    (0, 70_000, (9,)), (0, 1_000_003, (33,)), (-5, 2**31 - 1, (7,)), (5, 2, (3,)),
    (0, max(1, 10 - 10), ()), (0, max(1, 12 - 10), ()),   # the crop offset at t = 10, 12
])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_randint_is_jax_bitwise(lo, hi, shape, seed):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(np.uint32(seed)), shape, lo, hi))
    got = prng.randint(prng.prng_key(seed), shape, lo, hi)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,t,mf_dt", [(2, 3, 2), (2, 12, 10), (2, 3, 12)])
def test_crop_plan_draws_jax_crops(b, t, mf_dt):
    """The offset, its clamp (a crop longer than the video starts at 0) and
    the frame indices of JAX's ``crops`` from the same key."""
    r1, r2, r3 = jax.random.split(jax.random.PRNGKey(3), 3)
    offset, size, i_true, i_fake = tfs.crop_plan(prng.prng_key(3), b, t, mf_dt, 4)
    assert size == min(mf_dt, t)
    want = int(jax.random.randint(r1, (), 0, max(1, t - mf_dt)))
    assert offset == min(want, t - size) and 0 <= offset <= t - size
    assert np.array_equal(i_true.numpy(), np.asarray(jax.random.randint(r2, (4,), 0, b * t)))
    assert np.array_equal(i_fake.numpy(), np.asarray(jax.random.randint(r3, (4,), 0, b * (t - 1))))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bce", [False, True])
def test_disc_and_gen_losses_match_jax(bce):
    rng = np.random.default_rng(int(bce))
    pred = (2 * rng.standard_normal((4, 5))).astype(np.float32)
    for real in (False, True):
        _close(D.disc_loss(t(pred), real, bce), JD.disc_loss(jnp.asarray(pred), real, bce), 1e-6)
    _close(D.gen_loss(t(pred), bce), JD.gen_loss(jnp.asarray(pred), bce), 1e-6)
    a = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(3)]
    b = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(3)]
    kind = "l2" if bce else "l1"
    _close(D.fmap_loss([t(x) for x in a], [t(x) for x in b], kind),
           JD.fmap_loss([jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b], kind), 1e-6)
    if not bce:   # hinge: lower on the right side
        assert float(D.disc_loss(torch.full((4, 1), 2.0), True)) < float(
            D.disc_loss(torch.full((4, 1), -2.0), True))


@pytest.fixture(scope="module")
def disc_case():
    """Numpy-drawn discriminators and inputs, and JAX's references in one jit:
    both nets' outputs and feature maps, ``vgg_loss``, and each
    discriminator's loss (the temporal one with its gp) with its gradients."""
    fs, ds, dt = gan_specs(pfs, D)
    _, jds, jdt = gan_specs(jfs, JD)
    key = jax.random.PRNGKey(0)
    nets = {"ds_params": random_like(jax.eval_shape(lambda: JD.init_patch_disc(key, jds)), 1),
            "dt_params": random_like(jax.eval_shape(lambda: JD.init_temp_disc(key, jdt)), 2)}
    rng = np.random.default_rng(3)
    x = {"x_true": rng.uniform(-1, 1, (GAN_BATCH, 2, S, S, 3)), "x_fake": rng.uniform(-1, 1, (GAN_BATCH, 2, S, S, 3)),
         "f_true": rng.uniform(-1, 1, (4, S, S, 3)), "f_fake": rng.uniform(-1, 1, (4, S, S, 3))}
    x = {k: v.astype(np.float32) for k, v in x.items()}

    def disc_loss(apply, spec, params, real, fake):   # JAX's dt_loss_fn / ds_loss_fn
        p_sn = jmaterialize(params)
        loss = 0.5 * (JD.disc_loss(apply(p_sn, fake, spec)[0], False, spec.bce_loss)
                      + JD.disc_loss(apply(p_sn, real, spec)[0], True, spec.bce_loss))
        if spec.gp_weight <= 0:
            return loss, 0.0
        gp = JD.gradient_penalty(lambda xx: apply(p_sn, xx, spec), real)
        return loss + spec.gp_weight * gp, gp

    @jax.jit
    def reference(nets, x):
        dt_sn, ds_sn = jmaterialize(nets["dt_params"]), jmaterialize(nets["ds_params"])
        out = {"temp": JD.temp_disc_apply(dt_sn, x["x_fake"], jdt),
               "patch": JD.patch_disc_apply(ds_sn, x["f_fake"], jds),
               "vgg": jvgg.vgg_loss(x["f_true"], x["f_fake"])}
        for name, apply, spec, real, fake in (
                ("dt", JD.temp_disc_apply, jdt, "x_true", "x_fake"),
                ("ds", JD.patch_disc_apply, jds, "f_true", "f_fake")):
            (loss, gp), g = jax.value_and_grad(
                lambda p: disc_loss(apply, spec, p, x[real], x[fake]), has_aux=True)(nets[f"{name}_params"])
            out[name] = (loss, gp, g)
        return out

    ref = reference(nets, x)
    return (fs, ds, dt), bridge_gan_params(nets, device=CPU), {k: t(v) for k, v in x.items()}, ref


def test_discriminators_and_vgg_match_jax(disc_case):
    (_, ds, dt), nets, x, ref = disc_case
    with torch.no_grad():
        pred, fmaps = D.temp_disc_apply(materialize_spectral_norm(nets["dt_params"]), x["x_fake"], dt)
        assert pred.shape == (GAN_BATCH, 1) and len(fmaps) == 4
        for got, want in zip([pred] + fmaps, [ref["temp"][0]] + list(ref["temp"][1])):
            _close(got, want)
        pred, fmaps = D.patch_disc_apply(materialize_spectral_norm(nets["ds_params"]), x["f_fake"], ds)
        assert pred.shape == (4, 14, 14, 1) and len(fmaps) == 1
        for got, want in zip([pred] + fmaps, [ref["patch"][0]] + list(ref["patch"][1])):
            _close(got, want)
        _close(vgg.vgg_loss(vgg.VGG19(), x["f_true"], x["f_fake"]), ref["vgg"])


@pytest.mark.parametrize("which", ["dt", "ds"])
def test_disc_loss_and_gradients_match_jax(disc_case, which):
    (fs, ds, dt), nets, x, ref = disc_case
    losses = tfs.GanLosses(fs, ds, dt)
    params = nets[f"{which}_params"]
    for leaf in float_leaves(tfs.trainable(params)):
        leaf.requires_grad_(True)
    real, fake = (x["x_true"], x["x_fake"]) if which == "dt" else (x["f_true"], x["f_fake"])
    loss, gp = losses.disc_loss(which, params, real, fake)
    grads = tfs.trainable(bridge_gan_params(
        {f"{which}_params": np_tree(ref[which][2])}, device=CPU)[f"{which}_params"])
    got = dict(zip(flatten(grads), torch.autograd.grad(loss, float_leaves(tfs.trainable(params)))))
    want_loss, want_gp, _ = ref[which]
    _close(loss.detach(), want_loss)
    _close(gp.detach(), want_gp)
    if which == "dt":   # the spatial disc's gp weight is 0, as configs/first_stage.yaml has it
        assert float(want_gp) > 1e-3
    errs = _grad_errors(got, grads)
    assert max(errs.values()) <= TOL, max(errs.items(), key=lambda kv: kv[1])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_make_gan_optimizer_matches_jax():
    """Three steps on the same gradients, steps_per_epoch 2: the third runs
    at lr * gamma; u gets no update and no moments."""
    rng = np.random.default_rng(5)
    params = {"conv": {"w": rng.standard_normal((3, 3, 4, 8)), "b": rng.standard_normal(8),
                       "u": rng.standard_normal(8)},
              "gn": {"gamma": rng.uniform(0.5, 1.5, 8)}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    grads = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    kw = dict(lr=1e-2, weight_decay=1e-2, gamma=0.5, steps_per_epoch=2)

    @jax.jit
    def reference(params, grads):
        opt = jtfs.make_gan_optimizer(params, **kw)
        p, s = params, opt.init(params)
        for _ in range(3):
            u, s = opt.update(grads, s, p)
            p = optax.apply_updates(p, u)
        return p

    want = {k: torch.from_numpy(np.asarray(v)) for k, v in flatten(reference(params, grads)).items()}
    to_t = lambda tree: jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)  # noqa: E731
    p_tree, start = to_t(params), flatten(to_t(params))
    opt = tfs.make_gan_optimizer(**kw)
    state = opt.init(tfs.trainable(p_tree))
    leaves, g = float_leaves(tfs.trainable(p_tree)), float_leaves(tfs.trainable(to_t(grads)))
    assert len(leaves) == 3
    with torch.no_grad():
        for _ in range(3):
            torch._foreach_add_(leaves, opt.update([x.clone() for x in g], state, leaves))
    got = flatten(p_tree)
    assert torch.equal(got["conv/u"], start["conv/u"]) and torch.equal(want["conv/u"], start["conv/u"])
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= PARAM_TOL, k
    sched = tfs.staircase(1e-2, 0.5, 2)
    assert [sched(c) for c in range(5)] == [
        float(np.float32(1e-2) * np.float32(0.5) ** k) for k in (0, 0, 1, 1, 2)]
    assert sched(2) == pytest.approx(5e-3, rel=1e-6)
