"""The legacy flows and generators, the port against the JAX package on the
CPU: the fully connected flow (``flows/legacy``), the mixture-CDF flow, the
leapfrog flow, a MaCow v1 step, GIN actnorm / MADE / NIN (``flows/extras``),
the 3D motion generator and BigGAN, at the widths of JAX's own tests or
below; the two legacy converters bitwise against JAX's; the bridge both ways.

Params come from the port's ``init`` (JAX's draws from JAX's keys) carried
to JAX's layout by ``ckpt/jax_bridge.unbridge_direct``; each init against
JAX's own is ``-m slow`` (JAX's eager inits take seconds each here).  The
forward passes are held to 2e-4 (1 + max|ref|); the JAX references run
under ``jax.jit``.  Round trips ``inverse(forward(x)) = x`` are held to
JAX's own tests' tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.ckpt import torch_import as jti
from ipoke_tpu.flows import extras as jextras
from ipoke_tpu.flows import leapfrog as jleapfrog
from ipoke_tpu.flows import legacy as jlegacy
from ipoke_tpu.flows import macow_v1 as jmacow_v1
from ipoke_tpu.flows import mixcdf as jmixcdf
from ipoke_tpu.models import biggan as jbiggan
from ipoke_tpu.models import motion_generator as jmg
from ipoke_tpu_torch.ckpt import torch_import as ti
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_direct, unbridge_direct
from ipoke_tpu_torch.flows import extras, leapfrog, legacy, macow_v1, mixcdf
from ipoke_tpu_torch.models import biggan, motion_generator
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, assert_trees_equal, flatten, jit_o0, np_tree, t

TOL = 2e-4


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * (1 + float(np.abs(ref).max())), err


def _jax(tree):
    """A port tree in JAX's layout, as jnp arrays (bools stay bools)."""
    return jax.tree_util.tree_map(lambda a: a if isinstance(a, bool) else jnp.asarray(a),
                                  unbridge_direct(tree))


def _jspec(jmod_spec, spec):
    return jmod_spec(**dataclasses.asdict(spec))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturb(tree, seed, scale=0.1):
    """Every float leaf of a port tree moved by scale N(0, 1) (numpy), so
    actnorms and zero-init heads are not the identity."""
    rng = np.random.default_rng(seed)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x + scale * t(rng.standard_normal(tuple(x.shape)))
        return x

    return walk(tree)


# ---------------------------------------------------------------------------
# the fully connected flow
# ---------------------------------------------------------------------------

FC = legacy.FCFlowSpec(in_channels=16, embedding_dim=8, hidden_dim=32, hidden_depth=2, n_flows=4)


@pytest.mark.parametrize("option", ["none", "parallel", "sequential"])
def test_fc_flow_matches_jax(option):
    spec = dataclasses.replace(FC, conditioning_option=option)
    jspec = _jspec(jlegacy.FCFlowSpec, spec)
    p = _perturb(legacy.init_fc_flow(prng.prng_key(0), spec), 1, 0.05)
    pj = _jax(p)
    x, emb = _normal(2, 4, 16), _normal(3, 4, 8)
    z, ld = legacy.fc_flow_forward(p, spec, t(x), t(emb))
    # the nets' use_tanh flags are Python bools: the params go in as constants
    zj, ldj = jit_o0(lambda a, e: jlegacy.fc_flow_forward(pj, jspec, a, e))(x, emb)
    _close(z, zj)
    _close(ld, ldj)
    back = legacy.fc_flow_inverse(p, spec, z, t(emb))
    _close(back, jit_o0(lambda a, e: jlegacy.fc_flow_inverse(pj, jspec, a, e))(zj, emb))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)
    key = prng.prng_key(4)
    _close(legacy.fc_flow_sample(p, spec, key, t(emb)),
           jlegacy.fc_flow_sample(pj, jspec, jax.random.PRNGKey(4), jnp.asarray(emb)))


def test_vec_actnorm_data_init_and_leaky_relu():
    x = 3.0 * _normal(5, 64, 12) + 1.5
    p = legacy.vec_actnorm_data_init(legacy.init_vec_actnorm(12), t(x))
    pj = jlegacy.vec_actnorm_data_init(jlegacy.init_vec_actnorm(12), jnp.asarray(x))
    for k in ("loc", "scale"):
        _close(p[k], pj[k], 1e-6)
    y, _ = legacy.vec_actnorm_forward(p, t(x))
    assert abs(float(y.mean())) < 1e-4 and abs(float(y.std(unbiased=False)) - 1.0) < 1e-2
    r, _ = legacy.inv_leaky_relu_forward(t(x - 1.5))
    _close(r, jlegacy.inv_leaky_relu_forward(jnp.asarray(x - 1.5))[0], 1e-7)
    _close(legacy.inv_leaky_relu_inverse(r), x - 1.5, 1e-6)


# ---------------------------------------------------------------------------
# the mixture-CDF flow
# ---------------------------------------------------------------------------

def test_mixlogcdf_and_its_bisection_match_jax():
    x, k = _normal(9, 2, 8, 8, 3), 4
    logits, means = _normal(10, 2, 8, 8, 3, k), _normal(11, 2, 8, 8, 3, k)
    logscales = -0.5 + 0.2 * _normal(12, 2, 8, 8, 3, k)
    args = [t(a) for a in (logits, means, logscales)]
    y = torch.exp(mixcdf.mix_log_cdf(t(x), *args))
    _close(y, jnp.exp(jmixcdf.mix_log_cdf(x, logits, means, logscales)), 1e-6)
    _close(mixcdf.mix_log_pdf(t(x), *args), jmixcdf.mix_log_pdf(x, logits, means, logscales))
    x_rec = mixcdf.inv_mixlogcdf(y, *args, n_iter=80)
    np.testing.assert_allclose(x_rec.numpy(), x, atol=1e-3)
    ref = jit_o0(jmixcdf.inv_mixlogcdf)(jnp.asarray(y.numpy()), logits, means, logscales)
    _close(mixcdf.inv_mixlogcdf(y, *args), ref, 1e-5)


def test_mixcdf_flow_matches_jax():
    spec = mixcdf.MixCDFSpec(channels=8, hidden_dim=16, components=3, n_flows=2)
    jspec = _jspec(jmixcdf.MixCDFSpec, spec)
    p = _perturb(mixcdf.init_flow(prng.prng_key(10), spec), 13, 0.05)
    pj = _jax(p)
    x = _normal(11, 2, 8, 8, 8)
    z, ld = mixcdf.flow_forward(p, t(x), spec)
    zj, ldj = jit_o0(lambda p_, a: jmixcdf.flow_forward(p_, a, jspec))(pj, x)
    _close(z, zj)
    _close(ld, ldj)
    assert bool(torch.isfinite(ld).all())
    back = mixcdf.flow_inverse(p, z, spec)
    np.testing.assert_allclose(back.numpy(), x, atol=5e-3)
    _close(back, jit_o0(lambda p_, a: jmixcdf.flow_inverse(p_, a, jspec))(pj, zj), 1e-3)


# ---------------------------------------------------------------------------
# the leapfrog flow
# ---------------------------------------------------------------------------

def test_leap_flow_matches_jax_and_preserves_volume():
    spec = leapfrog.LeapFlowSpec(in_channels=12, hidden_dim=32, n_flows=3)
    jspec = _jspec(jleapfrog.LeapFlowSpec, spec)
    p = _perturb(leapfrog.init_leap_flow(prng.prng_key(20), spec), 21, 0.05)
    pj = _jax(p)
    x, v = _normal(22, 4, 12), _normal(23, 4, 12)
    x1, v1, ld = leapfrog.leap_flow_forward(p, spec, t(x), t(v))
    ref = jit_o0(lambda a, b: jleapfrog.leap_flow_forward(pj, jspec, a, b))(x, v)
    for got, want in zip((x1, v1, ld), ref):
        _close(got, want)
    expected = sum(float(torch.log(blk[k]["scale"].abs()).sum())
                   for blk in p["blocks"] for k in ("actnorm_x", "actnorm_v"))
    np.testing.assert_allclose(ld.numpy(), expected, atol=1e-4)   # the shears add nothing
    x0, v0 = leapfrog.leap_flow_inverse(p, spec, x1, v1)
    np.testing.assert_allclose(x0.numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v0.numpy(), v, rtol=1e-4, atol=1e-4)
    hx, hv = leapfrog.hmc_sample(p, spec, prng.prng_key(25), t(x))
    rx, rv = jleapfrog.hmc_sample(pj, jspec, jax.random.PRNGKey(25), jnp.asarray(x))
    _close(hx, rx)
    _close(hv, rv)
    assert float((hx - t(x)).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# MaCow v1
# ---------------------------------------------------------------------------

V1 = macow_v1.MaCowV1Spec(in_channels=8, hidden_channels=24)


@pytest.mark.parametrize("s_channels", [0, 4])
def test_macow_v1_step_matches_jax(s_channels):
    spec = dataclasses.replace(V1, s_channels=s_channels)
    jspec = _jspec(jmacow_v1.MaCowV1Spec, spec)
    p = _perturb(macow_v1.init_step_v1(prng.prng_key(0), spec), 30, 0.05)
    pj = _jax(p)
    x = _normal(1, 2, 8, 8, 8)
    s = _normal(2, 2, 8, 8, s_channels) if s_channels else None
    st = None if s is None else t(s)
    y, ld = macow_v1.step_v1_forward(p, t(x), spec, st)
    yj, ldj = jit_o0(lambda p_, a, c: jmacow_v1.step_v1_forward(p_, a, jspec, c))(pj, x, s)
    _close(y, yj)
    _close(ld, ldj)
    back = macow_v1.step_v1_inverse(p, y, spec, st)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-4)
    ref = jit_o0(lambda p_, a, c: jmacow_v1.step_v1_inverse(p_, a, jspec, c))(pj, yj, s)
    _close(back, ref)


@pytest.mark.parametrize("order", ["A", "B", "C", "D"])
def test_macow_v1_mcf_inverse_each_order(order):
    """One MCF's row-by-row inverse against JAX's scan, per order."""
    spec = dataclasses.replace(V1, s_channels=4)
    jspec = _jspec(jmacow_v1.MaCowV1Spec, spec)
    kernel = (2, 3) if order in "AB" else (3, 2)
    p = _perturb(macow_v1.init_mcf_v1(prng.prng_key(3), 8, kernel, spec), 31, 0.05)
    pj = _jax(p)
    z, s = _normal(4, 2, 8, 8, 8), _normal(5, 2, 8, 8, 4)
    got = macow_v1.mcf_v1_inverse(p, t(z), t(s), order, spec)
    _close(got, jmacow_v1.mcf_v1_inverse(pj, jnp.asarray(z), jnp.asarray(s), order, jspec))
    fwd, _ = macow_v1.mcf_v1_forward(p, got, t(s), order, spec)
    np.testing.assert_allclose(fwd.numpy(), z, atol=1e-4)


# ---------------------------------------------------------------------------
# GIN actnorm, MADE, NIN
# ---------------------------------------------------------------------------

def test_gin_actnorm_matches_jax_and_preserves_volume():
    x = 2.0 * _normal(0, 4, 8, 8, 6) + 1.0
    p = extras.gin_actnorm_data_init(extras.init_gin_actnorm(6), t(x))
    pj = jextras.gin_actnorm_data_init(jextras.init_gin_actnorm(6), jnp.asarray(x))
    np.testing.assert_allclose(float(torch.prod(extras._gin_scale(p))), 1.0, rtol=1e-4)
    y, ld = extras.gin_actnorm_forward(p, t(x))
    _close(y, jextras.gin_actnorm_forward(pj, jnp.asarray(x))[0], 1e-6)
    assert float(ld.abs().max()) == 0.0
    np.testing.assert_allclose(extras.gin_actnorm_inverse(p, y).numpy(), x, rtol=1e-4, atol=1e-4)


def test_made_masks_and_autoregressive_property():
    for got, want in zip(extras.made_masks(6, [24, 24], 12, seed=3),
                         jextras.made_masks(6, [24, 24], 12, seed=3)):
        assert np.array_equal(got, want)
    p = extras.init_ar_fc_net(prng.prng_key(1), nin=6, hidden_sizes=[24, 24], nout=12)
    x = _normal(2, 6)
    assert extras.ar_jacobian_is_triangular(p, t(x))
    _close(extras.ar_fc_net_apply(p, t(x)[None]),
           jextras.ar_fc_net_apply(jax.tree_util.tree_map(jnp.asarray, unbridge_direct(p)),
                                   jnp.asarray(x)[None]))
    broken = {"layers": [dict(layer, mask=torch.ones_like(layer["mask"])) for layer in p["layers"]]}
    assert not extras.ar_jacobian_is_triangular(broken, t(x))


@pytest.mark.parametrize("initializer", ["xavier", "data"])
def test_nin_matches_jax(initializer):
    p = extras.init_nin(prng.prng_key(3), 8, 5, initializer=initializer)
    pj = jextras.init_nin(jax.random.PRNGKey(3), 8, 5, initializer=initializer)
    _close(p["w"], pj["w"], 1e-6)
    x = 3.0 * _normal(4, 16, 4, 4, 8) + 2.0
    p, pj = extras.nin_data_init(p, t(x)), jextras.nin_data_init(pj, jnp.asarray(x))
    y = extras.nin_apply(p, t(x))
    _close(y, jextras.nin_apply(pj, jnp.asarray(x)))
    flat = y.reshape(-1, 5)
    np.testing.assert_allclose(flat.mean(0).numpy(), 0, atol=1e-4)
    np.testing.assert_allclose(flat.std(0, unbiased=False).numpy(), 1, atol=1e-2)


# ---------------------------------------------------------------------------
# the 3D motion generator and BigGAN
# ---------------------------------------------------------------------------

def test_motion_generator_matches_jax():
    spec = motion_generator.GeneratorSpec(img_size=64, z_dim=16, decoder_factor=2)
    jspec = _jspec(jmg.GeneratorSpec, spec)
    p = _perturb(motion_generator.init(prng.prng_key(2), spec), 40, 0.02)
    img, motion = _normal(3, 2, 64, 64, 3), _normal(4, 2, 16)
    with torch.no_grad():
        vid = motion_generator.apply(p, t(img), t(motion), spec)
    assert vid.shape == (2, 2, 64, 64, 3) and float(vid.abs().max()) <= 1.0
    ref = jit_o0(lambda p_, a, m: jmg.apply(p_, a, m, jspec))(_jax(p), img, motion)
    _close(vid, ref)


def test_biggan_matches_jax():
    spec = biggan.BigGANSpec(resolution=64, chn=8)
    jspec = _jspec(jbiggan.BigGANSpec, spec)
    p = _perturb(biggan.init(prng.prng_key(5), spec), 41, 0.02)
    pj = _jax(p)
    z, cls = _normal(6, 2, 100), _normal(7, 2, 128)
    onehot = np.eye(spec.n_class, dtype=np.float32)[[3, 997]]
    for c in (cls, onehot):   # a class embedding, or one-hot classes through 'linear'
        with torch.no_grad():
            img = biggan.apply(p, t(z), t(c), spec)
        assert img.shape == (2, 64, 64, 3) and float(img.abs().max()) <= 1.0
        _close(img, jit_o0(lambda p_, a, e: jbiggan.apply(p_, a, e, jspec))(pj, z, c))


def test_biggan_attention_matches_jax():
    """Self-attention (after block sa_id; the 64^2 stack never reaches it)."""
    p = _perturb(biggan._attn_init(prng.prng_key(8), 16, "cpu"), 42, 0.1)
    x = _normal(9, 2, 8, 8, 16)
    _close(biggan._attn_apply(p, t(x)), jbiggan._attn_apply(_jax(p), jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the converters and the bridge
# ---------------------------------------------------------------------------

def test_macow_v1_step_converts_as_jax():
    """A reference-shaped state_dict (the port's export) -> the port's
    converter equals JAX's bitwise, and equals the exported tree."""
    spec = dataclasses.replace(V1, s_channels=4)
    tree = unbridge_direct(_perturb(macow_v1.init_step_v1(prng.prng_key(6), spec), 50))
    sd = ti.export_macow_v1_step(tree, spec, prefix="flow")
    assert "flow.units.0.conv1.net.masked_conv.conv.weight_v" in sd
    ours = ti.convert_macow_v1_step(sd, spec, prefix="flow")
    assert_trees_equal(ours, np_tree(jti.convert_macow_v1_step(sd, _jspec(jmacow_v1.MaCowV1Spec,
                                                                         spec), prefix="flow")))
    assert_trees_equal(ours, tree)


@pytest.mark.parametrize("option", ["none", "sequential"])
def test_fc_flow_converts_as_jax(option):
    spec = dataclasses.replace(FC, conditioning_option=option)
    tree = unbridge_direct(_perturb(legacy.init_fc_flow(prng.prng_key(7), spec), 51))
    sd = ti.export_fc_flow(tree, spec)
    assert "sub_layers.3.coupling.t.1.main.6.weight" in sd
    ours = ti.convert_fc_flow(sd, spec)
    assert_trees_equal(ours, np_tree(jti.convert_fc_flow(sd, _jspec(jlegacy.FCFlowSpec, spec))))
    assert_trees_equal(ours, tree)


@pytest.mark.parametrize("module", ["fc_flow", "mixcdf", "leapfrog", "macow_v1", "extras",
                                    "motion_generator", "biggan"])
def test_legacy_tree_bridges_both_ways(module):
    """unbridge -> bridge gives the port's tree back bitwise, the kernels in
    JAX's layouts on the way (HWIO, 3D DHWIO; linear layers as they are)."""
    key = prng.prng_key(9)
    tree = {"fc_flow": lambda: legacy.init_fc_flow(key, dataclasses.replace(
                FC, conditioning_option="parallel")),
            "mixcdf": lambda: mixcdf.init_flow(key, mixcdf.MixCDFSpec(8, 16, 3, 1)),
            "leapfrog": lambda: leapfrog.init_leap_flow(key, leapfrog.LeapFlowSpec(8, 16)),
            "macow_v1": lambda: macow_v1.init_step_v1(key, dataclasses.replace(V1, s_channels=4)),
            "extras": lambda: {"made": extras.init_ar_fc_net(key, 4, [8], 8),
                               "nin": extras.init_nin(key, 4, 3)},
            "motion_generator": lambda: motion_generator.init(
                key, motion_generator.GeneratorSpec(img_size=64, z_dim=8, decoder_factor=1)),
            "biggan": lambda: biggan.init(key, biggan.BigGANSpec(resolution=64, chn=4))}[module]()
    jt = unbridge_direct(tree)
    back = bridge_direct(jt, CPU)
    a, b = flatten(tree), flatten(back)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], bool):
            assert b[k] is a[k], k
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    kernels = [v for k, v in flatten(jt).items() if k.endswith(("/w", "/v")) and v.ndim >= 4]
    if module == "motion_generator":
        assert any(w.ndim == 5 for w in kernels)


# ---------------------------------------------------------------------------
# slow: each init against JAX's own draws
# ---------------------------------------------------------------------------

def _assert_init_equal(port, ref):
    a, b = flatten(unbridge_direct(port)), flatten(np_tree(ref))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], bool):
            assert a[k] == bool(b[k]), k
        else:
            _close(a[k], b[k], 1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("module", ["fc_flow", "mixcdf", "leapfrog", "macow_v1", "extras",
                                    "motion_generator", "biggan"])
def test_legacy_init_matches_jax(module):
    key, jkey = prng.prng_key(11), jax.random.PRNGKey(11)
    fc = dataclasses.replace(FC, conditioning_option="parallel")
    v1 = dataclasses.replace(V1, s_channels=4)
    mc, lf = mixcdf.MixCDFSpec(8, 16, 3, 2), leapfrog.LeapFlowSpec(8, 16)
    mg = motion_generator.GeneratorSpec(img_size=64, z_dim=8, decoder_factor=1)
    bg = biggan.BigGANSpec(resolution=64, chn=4)
    port, ref = {
        "fc_flow": lambda: (legacy.init_fc_flow(key, fc),
                            jlegacy.init_fc_flow(jkey, _jspec(jlegacy.FCFlowSpec, fc))),
        "mixcdf": lambda: (mixcdf.init_flow(key, mc),
                           jmixcdf.init_flow(jkey, _jspec(jmixcdf.MixCDFSpec, mc))),
        "leapfrog": lambda: (leapfrog.init_leap_flow(key, lf),
                             jleapfrog.init_leap_flow(jkey, _jspec(jleapfrog.LeapFlowSpec, lf))),
        "macow_v1": lambda: (macow_v1.init_step_v1(key, v1),
                             jmacow_v1.init_step_v1(jkey, _jspec(jmacow_v1.MaCowV1Spec, v1))),
        "extras": lambda: ({"made": extras.init_ar_fc_net(key, 4, [8], 8),
                            "nin": extras.init_nin(key, 4, 3)},
                           {"made": jextras.init_ar_fc_net(jkey, 4, [8], 8),
                            "nin": jextras.init_nin(jkey, 4, 3)}),
        "motion_generator": lambda: (motion_generator.init(key, mg),
                                     jmg.init(jkey, _jspec(jmg.GeneratorSpec, mg))),
        "biggan": lambda: (biggan.init(key, bg), jbiggan.init(jkey, _jspec(jbiggan.BigGANSpec, bg))),
    }[module]()
    _assert_init_equal(port, ref)
