"""The flow variants the configs expose, the port against the JAX package on
the CPU: the transforms, conv-LU, the gated conv and the attention NICE
coupling, ``cond_conv`` units, ``condition_nice`` steps, multistack flows
and augmented input, at tiny shapes (C=8, hidden 16, h 16, 8x8, B=2).

Params come from the port's ``init`` (JAX's draws from JAX's keys) carried
to JAX's layout by ``ckpt/jax_bridge``, as in tests/test_torch_flow.py,
except where the init itself is the subject.  Tolerance 2e-4, relative to
1 + max|ref|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.flows import attention as jattn
from ipoke_tpu.flows import macow as jmacow
from ipoke_tpu.flows import multistack as jmultistack
from ipoke_tpu.flows import nice as jnice
from ipoke_tpu.flows import permute as jpermute
from ipoke_tpu.flows import transformer as jtransformer
from ipoke_tpu.flows import transforms as jtransforms
from ipoke_tpu.flows.macow import FlowSpec
from ipoke_tpu.flows.multistack import StackSpec as JStackSpec
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_flow, unbridge_flow
from ipoke_tpu_torch.flows import attention, macow, mcf, nice, permute, transformer
from ipoke_tpu_torch.flows import transforms
from ipoke_tpu_torch.flows.multistack import StackSpec
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, np_tree, port_flow_spec, set_wn_gains, t

TOL = 2e-4
B, S, C, HID, HC = 2, 8, 8, 16, 16


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * (1 + float(np.abs(ref).max())), err


def _data(seed, c=C, hc=HC, s=S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, s, c)).astype(np.float32),
            rng.standard_normal((B, s, s, hc)).astype(np.float32))


def _spec(**kw):
    return FlowSpec(num_steps=(1,), in_channels=C, hidden_channels=HID, h_channels=HC, factor=4,
                    **kw)


def _flow(jspec, seed=3, gain=0.1):
    """(port params, JAX params) of ``jspec``'s flow, gains set to ``gain``."""
    pj = set_wn_gains(jax.tree_util.tree_map(jnp.asarray, unbridge_flow(
        transformer.init(prng.prng_key(seed), port_flow_spec(jspec), CPU))), gain)
    return bridge_flow(np_tree(pj), CPU), pj


def _step0(pt, pj):
    """Level 0's first MaCowStep on both sides (JAX's is stacked)."""
    return (pt["levels"][0]["steps"][0],
            jax.tree_util.tree_map(lambda a: a[0], pj["levels"][0]["steps"]))


def _jit(fn, *static):
    """``fn(*args, *static)`` jitted: one compile, not one per eager op."""
    return jax.jit(lambda *args: fn(*args, *static))


def _hwio(tree):
    """The port's OIHW convs of a non-flow tree in JAX's HWIO."""
    if isinstance(tree, dict):
        return {k: (core.to_hwio(v) if k in ("w", "v") and v.dim() == 4 else _hwio(v))
                for k, v in tree.items()}
    return tree


def _assert_init_close(port, ref):
    flat_p = jax.tree_util.tree_leaves_with_path(port, is_leaf=lambda x: isinstance(x, torch.Tensor))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_p) == len(flat_r)
    for path, leaf in flat_p:
        _close(leaf, flat_r[path], 1e-6)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(transforms.TRANSFORMS))
def test_transform_matches_jax(name):
    T, JT = transforms.get_transform(name), jtransforms.get_transform(name)
    rng = np.random.default_rng(1)
    raw = 0.5 * rng.standard_normal((B, S, S, T.n_params * C)).astype(np.float32)
    z = rng.standard_normal((B, S, S, C)).astype(np.float32)
    params, jparams = T.calc_params(t(raw), 0.7), JT.calc_params(jnp.asarray(raw), 0.7)
    for a, b in zip(params, jparams):
        _close(a, b)
    out, ld = T.fwd(t(z), params)
    ref, ref_ld = JT.fwd(jnp.asarray(z), jparams)
    _close(out, ref)
    _close(ld, ref_ld)
    if name == "symm_elu":   # forward only, in JAX too
        with pytest.raises(NotImplementedError, match="no inverse"):
            T.bwd(t(z), params)
        return
    back, back_ld = T.bwd(out, params)
    ref_back, ref_back_ld = JT.bwd(ref, jparams)
    _close(back, ref_back)
    _close(back_ld, ref_back_ld)


# ---------------------------------------------------------------------------
# conv-LU 1x1
# ---------------------------------------------------------------------------

def test_conv_lu_matches_jax():
    """The init from JAX's key (numpy QR, then scipy's LU, on the port's
    draw, within 7.2e-7 of JAX's): every pivot the same, every leaf within
    1e-6; then forward, logdet and inverse on JAX's leaves."""
    key = 5
    p = permute.init_conv_lu(prng.prng_key(key), C)
    ref = jpermute.init_conv_lu(jax.random.PRNGKey(key), C)
    assert torch.equal(p["permutated"], t(ref["permutated"]))
    assert torch.equal(p["sign_s"], t(ref["sign_s"]))
    for k in ref:
        _close(p[k], ref[k], 1e-6)
    p = {k: t(v) for k, v in ref.items()}
    x, _ = _data(2)
    y, ld = permute.conv_lu_forward(p, t(x))
    ref_y, ref_ld = jpermute.conv_lu_forward(ref, jnp.asarray(x))
    _close(y, ref_y)
    _close(ld, ref_ld)
    _close(permute.conv_lu_inverse(p, y), jpermute.conv_lu_inverse(ref, ref_y))


def test_conv_lu_pivots_match_jax():
    """QR and LU of the port's draw against JAX's, 23 inits (C=16 and 32 on
    keys 0-9, C=96, plants_128's augmented width, on keys 0-2): no pivot or
    sign flips on a near tie, and every leaf lies within 1e-4 of JAX's."""
    for nf, keys in ((16, 10), (32, 10), (96, 3)):
        for key in range(keys):
            p = permute.init_conv_lu(prng.prng_key(key), nf)
            ref = jpermute.init_conv_lu(jax.random.PRNGKey(key), nf)
            assert torch.equal(p["permutated"], t(ref["permutated"])), (nf, key)
            assert torch.equal(p["sign_s"], t(ref["sign_s"])), (nf, key)
            for k in ref:
                _close(p[k], ref[k], 1e-4)


# ---------------------------------------------------------------------------
# gated conv, attention
# ---------------------------------------------------------------------------

def test_gated_conv_and_attention_layer_match_jax():
    """Both inits from JAX's key (conv_sc and cond_conv included), then the
    gated conv with a conditioning input, the attention layer and the
    conv-attention block with its layer norm."""
    k = 7
    p = attention.init_gated_conv(prng.prng_key(k), C, dim_out=HID, dim_cond=4)
    ref = jattn.init_gated_conv(jax.random.PRNGKey(k), C, dim_out=HID, dim_cond=4)
    _assert_init_close(_hwio(p), ref)
    x, xc = _data(3, hc=4)
    _close(attention.gated_conv_apply(p, t(x), t(xc)),
           jax.jit(jattn.gated_conv_apply)(ref, jnp.asarray(x), jnp.asarray(xc)))
    pb = attention.init_conv_attn_block(prng.prng_key(k + 1), HID, S)
    ref_b = jattn.init_conv_attn_block(jax.random.PRNGKey(k + 1), HID, S)
    _assert_init_close(_hwio(pb), ref_b)
    rng = np.random.default_rng(4)
    pb["ln"] = {n: t(1 + 0.1 * rng.standard_normal((S, S, HID))) for n in ("gamma", "beta")}
    ref_b = dict(ref_b, ln={n: jnp.asarray(v.numpy()) for n, v in pb["ln"].items()})
    h, pos = (rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, S, HID), (S, S, HID)))
    _close(attention.attn_layer_apply(pb["attn"], t(h), t(pos), 2),
           _jit(jattn.attn_layer_apply, 2)(ref_b["attn"], jnp.asarray(h), jnp.asarray(pos)))
    _close(attention.conv_attn_block_apply(pb, t(h), t(pos), 4),
           _jit(jattn.conv_attn_block_apply, 4)(ref_b, jnp.asarray(h), jnp.asarray(pos)))


def test_attention_nice_coupling_matches_jax():
    """The attention NICE coupling with h (``condition_nice``) and 2 heads:
    JAX's init (``in_resnet`` and ``conv1`` from one subkey), forward and
    inverse."""
    kw = dict(hidden=HID, h_channels=HC, split_type="skip", order="down", attention=True,
              heads=2, spatial_size=S)
    p = nice.init_nice(prng.prng_key(9), C, **kw)
    ref = jnice.init_nice(jax.random.PRNGKey(9), C, **kw)
    _assert_init_close(_hwio(p), ref)
    ref = set_wn_gains(ref, 0.3)
    p["net"]["conv3"]["g"] = t(ref["net"]["conv3"]["g"])
    x, h = _data(5)
    ckw = dict(in_channels=C, split_type="skip", order="down", heads=2)
    y, ld = nice.forward(p, t(x), t(h), **ckw)
    ref_y, ref_ld = jax.jit(lambda *a: jnice.forward(*a, **ckw))(ref, jnp.asarray(x),
                                                                  jnp.asarray(h))
    _close(y, ref_y)
    _close(ld, ref_ld)
    _close(nice.inverse(p, y, t(h), **ckw),
           jax.jit(lambda *a: jnice.inverse(*a, **ckw))(ref, ref_y, jnp.asarray(h)))


# ---------------------------------------------------------------------------
# MaCow units and steps
# ---------------------------------------------------------------------------

def test_cond_conv_unit_matches_jax():
    """A ``cond_conv`` MaCowUnit: its gated conv on h, forward, and the
    inverse on 'scan' and on 'cuda_unit' (K2's plain version on the CPU),
    which reads the gated h."""
    jspec = _spec(cond_conv=True)
    pt, pj = _step0(*_flow(jspec))
    unit, ref = pt["units1"][0], pj["units1"][0]
    assert "cond_conv_block" in unit
    x, h = _data(6)
    y, ld = macow.macow_unit_forward(unit, t(x), t(h), port_flow_spec(jspec))
    ref_y, ref_ld = _jit(jmacow.macow_unit_forward, jspec)(ref, jnp.asarray(x), jnp.asarray(h))
    _close(y, ref_y)
    _close(ld, ref_ld)
    ref_x = _jit(jmacow.macow_unit_inverse, jspec)(ref, ref_y, jnp.asarray(h))
    for backend in ("scan", "cuda_unit"):
        _close(macow.macow_unit_inverse(unit, y, t(h), port_flow_spec(jspec, mcf_backend=backend)),
               ref_x)


def test_condition_nice_step_matches_jax():
    """A ``condition_nice`` MaCowStep: h reaches its four NICE couplings."""
    jspec = _spec(condition_nice=True)
    (pt, pj), spec = _step0(*_flow(jspec)), port_flow_spec(jspec)
    assert pt["coupling1_up"]["net"]["conv3"]["v"].shape[1] == HID + HC
    x, h = _data(7)
    y, ld = macow.macow_step_forward(pt, t(x), t(h), spec)
    ref_y, ref_ld = _jit(jmacow.macow_step_forward, jspec)(pj, jnp.asarray(x), jnp.asarray(h))
    _close(y, ref_y)
    _close(ld, ref_ld)
    _close(macow.macow_step_inverse(pt, y, t(h), spec),
           _jit(jmacow.macow_step_inverse, jspec)(pj, ref_y, jnp.asarray(h)))


def test_use_1x1_prior_matches_jax():
    """``use_1x1``: the prior's permutation is a conv-LU 1x1 conv drawn from
    JAX's key (the step's ``conv1x1`` stays a shuffle)."""
    jspec = _spec(use_1x1=True)
    pt, pj = _flow(jspec)
    assert set(pt["levels"][0]["shuffle"]) == {"permutated", "sign_s", "lmask", "l", "u", "log_s"}
    assert set(pt["levels"][0]["steps"][0]["conv1x1"]) == {"fwd_idx", "inv_idx"}
    prior, ref = pt["levels"][0]["prior"], pj["levels"][0]["prior"]
    x, h = _data(8)
    spec = port_flow_spec(jspec)
    y, ld = macow.prior_forward(prior, t(x), t(h), 4, spec)
    ref_y, ref_ld = _jit(jmacow.prior_forward, 4, jspec)(ref, jnp.asarray(x), jnp.asarray(h))
    _close(y, ref_y)
    _close(ld, ref_ld)
    _close(macow.prior_inverse(prior, y, t(h), 4, spec),
           _jit(jmacow.prior_inverse, 4, jspec)(ref, ref_y, jnp.asarray(h)))


@pytest.mark.parametrize("transform", ["nlsq", "additive"])
def test_non_affine_unit_takes_the_plain_loop(transform, monkeypatch):
    """A non-affine transform on 'cuda' and 'cuda_unit' equals JAX's scan,
    and neither kernel's wrapper is called: the route is decided from the
    spec, before any launch."""
    jspec = _spec(transform=transform)
    pt, pj = _step0(*_flow(jspec))
    unit, ref = pt["units1"][0], pj["units1"][0]
    calls = []
    monkeypatch.setattr(mcf, "mcf_inverse", lambda *a, **k: calls.append("K1"))
    monkeypatch.setattr(macow, "macow_unit_inverse_cuda", lambda *a, **k: calls.append("K2"))
    x, h = _data(9)
    ref_y, _ = _jit(jmacow.macow_unit_forward, jspec)(ref, jnp.asarray(x), jnp.asarray(h))
    ref_x = _jit(jmacow.macow_unit_inverse, jspec)(ref, ref_y, jnp.asarray(h))
    for backend in ("cuda", "cuda_unit"):
        out = macow.macow_unit_inverse(unit, t(np.asarray(ref_y)), t(h),
                                       port_flow_spec(jspec, mcf_backend=backend))
        _close(out, ref_x)
    assert calls == []


# ---------------------------------------------------------------------------
# multistack
# ---------------------------------------------------------------------------

STACK = dict(levels=((1,), (1,)), in_channels=C, mid_channels_factor=2, h_channels=HC)


@pytest.mark.parametrize("reshape,factors", [("none", (4, 4)), ("down", (4, 4)),
                                             ("up", (4, 2))])
def test_multistack_matches_jax(reshape, factors):
    """A stack of two one-level blocks with its reshape: forward and logdet
    against JAX's, through the bridge both ways (an 'up' stack's h
    transforms are transpose convs), the inverse back to x (so it is JAX's
    inverse on the forward's image; one jitted JAX stack compiles for ~4 s
    here), and ``reverse_input_shape``."""
    c = C
    jspec = JStackSpec(reshape=reshape, factors=factors, **STACK)
    spec = StackSpec(reshape=reshape, factors=factors, **STACK)
    pt = transformer.init(prng.prng_key(11), spec, CPU)
    if reshape != "none":
        assert len(pt["h_transforms"]) == 1
        w = pt["h_transforms"][0]["conv"]["w"]
        assert w.shape == (HC, HC, 3, 3)
    pj = set_wn_gains(jax.tree_util.tree_map(jnp.asarray, unbridge_flow(pt)), 0.1)
    pt = bridge_flow(np_tree(pj), CPU)
    x, h = _data(12, c=c)
    y, ld = transformer.forward(pt, spec, t(x), t(h))
    ref_y, ref_ld = jax.jit(lambda *a: jmultistack.forward(*a, jspec))(
        pj, jnp.asarray(x), jnp.asarray(h))
    _close(y, ref_y)
    _close(ld, ref_ld)
    _close(transformer.reverse(pt, spec, y, t(h)), x)
    assert transformer.reverse_input_shape(spec, B, S, c) == \
        jtransformer.reverse_input_shape(jspec, B, S, c) == tuple(y.shape)


def test_stack_spec_from_config_matches_jax():
    arch = {"levels": [[1, 1], [1]], "factors": [4, 4], "flow_in_channels": 8,
            "flow_mid_channels_factor": 2, "h_channels": 16, "reshape": "down",
            "use1x1": True, "condition_nice": True, "attention": True}
    jspec = jtransformer.stack_spec_from_config(arch)
    spec = transformer.stack_spec_from_config(arch)
    for j, p in zip(jspec.block_specs(), spec.block_specs()):
        assert port_flow_spec(j) == p
        assert not p.attention and not p.cond_conv
    flat = dict(arch, num_steps=[1], flow_mid_channels=16, flow_attn_heads=2, ssize=8)
    assert transformer.spec_from_config(flat) == port_flow_spec(jtransformer.spec_from_config(flat))


# ---------------------------------------------------------------------------
# augmented input
# ---------------------------------------------------------------------------

AUG = 4


def test_augmented_second_stage():
    """``augmented_input``: the spec as JAX builds it; ``forward_density``'s
    flow input is the motion latent beside JAX's draw from the step's key
    times ``scale_augment`` plus ``shift_augment``; a process's rows of a
    sharded batch take those rows of the whole draw; no key raises, where
    JAX's validation fails; ``forward_sample`` decodes the reverse without
    the augment channels."""
    from ipoke_tpu.experiments.second_stage import build_spec_from_config as jax_build_spec
    from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
    from ipoke_tpu_torch.models import second_stage
    from torch_port_util import port_second_stage_spec, tiny_config

    cfg = tiny_config("unused")
    cfg["architecture"].update(augmented_input=True, augment_channels=AUG,
                               scale_augmentation=True, shift_augmentation=True)
    spec = build_spec_from_config(cfg, mcf_backend="scan")
    assert port_second_stage_spec(jax_build_spec(cfg), mcf_backend="scan") == spec
    assert spec.flow_in_channels == spec.first_stage.z_dim + AUG
    params = second_stage.init(prng.prng_key(1), spec, device=CPU)
    assert torch.equal(params["scale_augment"], torch.ones(AUG))
    rng = np.random.default_rng(13)
    params["scale_augment"], params["shift_augment"] = (t(rng.standard_normal(AUG))
                                                        for _ in range(2))
    batch = {"images": t(rng.uniform(-1, 1, (B, 3, 64, 64, 3))),
             "poke": t(rng.standard_normal((B, 64, 64, 2)))}
    key = prng.prng_key(5)
    out, ld, cond = second_stage.forward_density(params, spec, batch, rng=key)
    motion, _ = second_stage.encode_first_stage(params, spec, batch["images"])
    draw = t(jax.random.normal(jax.random.PRNGKey(5), tuple(motion.shape[:-1]) + (AUG,)))
    aug = draw * params["scale_augment"] + params["shift_augment"]
    ref, ref_ld = transformer.forward(params["flow"], spec.flow, torch.cat([motion, aug], -1), cond)
    _close(out, ref.numpy())
    _close(ld, ref_ld.numpy())
    half = {k: v[1:] for k, v in batch.items()}
    _close(second_stage.forward_density(params, spec, half, rng=key, rows=(1, B))[0],
           out[1:].numpy())
    with pytest.raises(ValueError, match="JAX key"):
        second_stage.forward_density(params, spec, batch)
    z = t(rng.standard_normal(transformer.reverse_input_shape(spec.flow, B, 8, 16 + AUG)))
    vid = second_stage.forward_sample(params, spec, batch, z=z, length=2)[0]
    motion_s = transformer.reverse(params["flow"], spec.flow, z, cond)[..., :-AUG]
    _close(vid, second_stage.decode_first_stage(params, spec, motion_s, batch["images"][:, 0],
                                                2).numpy())


@pytest.mark.parametrize("reshape", ["down", "up"])
def test_distillation_of_a_stack_teacher(reshape):
    """A direct student reads the stack's draw at the motion geometry, as
    JAX maps it; a flow student of a stack teacher raises, as in JAX."""
    from ipoke_tpu.train import distill as jdistill
    from ipoke_tpu_torch.train import distill

    jspec = JStackSpec(reshape=reshape, factors=(4, 4), **STACK)
    spec = StackSpec(reshape=reshape, factors=(4, 4), **STACK)
    z, _ = _data(14, c=16)
    _close(distill._z_at_motion_geometry(spec, t(z)),
           jdistill._z_at_motion_geometry(jspec, jnp.asarray(z)), 0)
    with pytest.raises(ValueError, match="MultiscaleStack"):
        distill.flow_student_spec(spec, (1, 1))
