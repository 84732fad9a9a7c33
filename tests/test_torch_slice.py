"""The port's sampling slice, ``models/second_stage.forward_sample``, against
the JAX package on the CPU: a tiny second stage initialised by JAX (flow
output gains set non-zero so no coupling is the identity), carried across by
``ckpt/jax_bridge``, then the same numpy z and batch through both."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu import registry as jregistry
from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.flows.macow import FlowSpec
from ipoke_tpu.models import second_stage as jss
from ipoke_tpu.models.encoders import WrapperSpec
from ipoke_tpu.models.first_stage import FirstStageSpec
from ipoke_tpu_torch import registry
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.utils import synth
from torch_port_util import CPU, np_tree, port_second_stage_spec, set_wn_gains, t

B, T, S = 2, 3, 32
F32_TOL = 2e-4      # the flow's tolerance; the decode adds only convs and norms
# The SPADE decoder in bf16 (8-bit mantissa) rounds at other places in the
# two frameworks: JAX rounds every step of its norms to bf16, torch's norms
# round once.  On this model JAX's own bf16 video lies 0.086 (max) / 0.0093
# (mean) from its f32 video, the port's 0.033 / 0.0036.  So the port's bf16
# video is held to the f32 reference at (max, mean) (0.1, 5e-3), and to
# JAX's bf16 video at (0.1, 1.5e-2), on the [-1, 1] scale.
BF16_VS_F32 = (0.1, 5e-3)
BF16_VS_BF16 = (0.1, 1.5e-2)


def _jax_spec(decode_dtype="f32"):
    fs = FirstStageSpec(z_dim=16, spatial_size=S, max_frames=T, enc_channels=(16, 16, 16, 16),
                        dec_channels=(16, 16, 16), n_gru_layers=2, min_spatial_size=8,
                        motion_bias=True, full_sequence=True, decode_dtype=decode_dtype)
    flow = FlowSpec(num_steps=(1, 1), in_channels=16, hidden_channels=32, h_channels=32, factor=16)
    return jss.SecondStageSpec(
        flow=flow, first_stage=fs,
        poke_embedder=WrapperSpec(nf_in=2, nf_max=16, spatial_size=S, min_spatial_size=8, deterministic=True),
        conditioner=WrapperSpec(nf_in=3, nf_max=16, spatial_size=S, min_spatial_size=8, deterministic=False))


@pytest.fixture(scope="module")
def model():
    jspec = _jax_spec()
    p = jss.init(jax.random.PRNGKey(0), jspec)
    p = dict(p, flow=set_wn_gains(p["flow"], 0.05))
    rng = np.random.default_rng(1)
    batch = {"images": rng.standard_normal((B, T, S, S, 3)).astype(np.float32),
             "poke": rng.standard_normal((B, S, S, 2)).astype(np.float32)}
    z = rng.standard_normal((1, B, 8, 8, 16)).astype(np.float32)
    return p, jspec, batch, z


def _with_decode(jspec, decode_dtype):
    return dataclasses.replace(jspec, first_stage=dataclasses.replace(
        jspec.first_stage, decode_dtype=decode_dtype))


def _within(out, ref, bounds):
    diff = np.abs(out - ref)
    assert diff.max() < bounds[0] and diff.mean() < bounds[1], (diff.max(), diff.mean())


def _jax_sample(p, jspec, batch, z):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return np.asarray(jss.forward_sample(p, jspec, jb, None, z=jnp.asarray(z)))


def _port_sample(pt, spec, batch, z):
    return second_stage.forward_sample(pt, spec, {k: t(v) for k, v in batch.items()}, z=t(z)).numpy()


@pytest.mark.parametrize("decode_dtype", ["f32", "bf16"])
def test_forward_sample_matches_jax(model, decode_dtype):
    p, jspec, batch, z = model
    jspec = _with_decode(jspec, decode_dtype)
    spec = port_second_stage_spec(jspec, mcf_backend="cuda_unit")
    pt = bridge_second_stage(np_tree(p), spec, device=CPU)
    # example 1 gets a non-finite draw: the masks must agree, example 0 stays finite
    z_bad = z.copy()
    z_bad[0, 1, 3, 3, 5] = np.inf
    ref = _jax_sample(p, jspec, batch, z_bad)
    out = _port_sample(pt, spec, batch, z_bad)
    assert out.shape == ref.shape == (1, B, T - 1, S, S, 3)
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    assert np.isfinite(out[:, 0]).all() and not np.isfinite(out[:, 1]).all()
    fin = np.isfinite(ref)
    if decode_dtype == "f32":
        np.testing.assert_allclose(out[fin], ref[fin], rtol=F32_TOL, atol=F32_TOL)
    else:
        ref_f32 = _jax_sample(p, _with_decode(jspec, "f32"), batch, z_bad)
        _within(out[fin], ref_f32[fin], BF16_VS_F32)
        _within(out[fin], ref[fin], BF16_VS_BF16)
    # the port's own draw: same shape, finite, and seeded
    gen = torch.Generator().manual_seed(5)
    tb = {k: t(v) for k, v in batch.items()}
    v1 = second_stage.forward_sample(pt, spec, tb, generator=gen, n_samples=2)
    v2 = second_stage.forward_sample(pt, spec, tb, generator=gen.manual_seed(5), n_samples=2)
    assert v1.shape == (2, B, T - 1, S, S, 3) and torch.isfinite(v1).all()
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)


def test_batch_composition_invariance(model):
    """With z fixed per request, a batch of 2 equals each example run alone."""
    p, jspec, batch, z = model
    spec = port_second_stage_spec(jspec, mcf_backend="cuda_unit")
    pt = bridge_second_stage(np_tree(p), spec, device=CPU)
    both = _port_sample(pt, spec, batch, z)
    for i in range(B):
        one = _port_sample(pt, spec, {k: v[i:i + 1] for k, v in batch.items()}, z[:, i:i + 1])
        np.testing.assert_allclose(one[:, 0], both[:, i], rtol=1e-5, atol=1e-5)


def test_bridge_from_npz_and_synth_tree(model, tmp_path):
    p, jspec, _, _ = model
    spec = port_second_stage_spec(jspec)
    path = str(tmp_path / "ckpt.npz")
    jio.save(path, p, metadata={"step": 3})
    from_tree = bridge_second_stage(np_tree(p), spec, device=CPU)
    from_npz = bridge_second_stage(path, spec, device=CPU)
    flat_t, flat_n = _flatten(from_tree), _flatten(from_npz)
    assert flat_t.keys() == flat_n.keys()
    for k in flat_t:
        assert flat_t[k].dtype == flat_n[k].dtype and torch.equal(flat_t[k], flat_n[k]), k
    # the synthesised tree has exactly the bridged tree's leaves and shapes
    shapes = {k: (v.kind, v.shape) for k, v in _flatten(synth.param_shapes(spec)).items()}
    assert shapes == {k: ("perm" if v.dtype == torch.long else "float", tuple(v.shape))
                      for k, v in flat_t.items()}
    pt = synth.synth_params(spec, seed=0, device=CPU)
    perm = pt["flow"]["levels"][0]["shuffle"]["inv_idx"]
    assert sorted(perm.tolist()) == list(range(16))
    zeroed = synth.zero_flow_output_convs(pt["flow"])
    g = zeroed["levels"][0]["steps"][0]["units1"][0]["conv1"]["net"]["conv1x1"]["g"]
    assert not g.any() and zeroed["levels"][0]["steps"][0]["actnorm1"]["bias"] is \
        pt["flow"]["levels"][0]["steps"][0]["actnorm1"]["bias"]


def test_registry_specs_match_jax():
    """The port's registry builds the JAX registry's specs, and its
    synthesised flagship tree has the JAX tree's leaves (per step)."""
    for name, entry in registry.MODELS.items():
        jspec = jregistry.build_specs(jregistry.MODELS[name])
        spec = registry.build_specs(entry)
        assert spec == port_second_stage_spec(jspec, mcf_backend="cuda_unit"), name
        spec.validate()
    flagship = registry.build_specs(registry.MODELS[registry.FLAGSHIP])
    assert sum(flagship.flow.num_steps) == 50 and len(flagship.flow.num_steps) == 15
    # structure at full width, one step per level (the JAX tree stacks steps)
    jspec = jregistry.build_specs(jregistry.MODELS[registry.FLAGSHIP])
    jspec = dataclasses.replace(jspec, flow=dataclasses.replace(jspec.flow, num_steps=(1,) * 15))
    shapes = jax.eval_shape(lambda k: jss.init(k, jspec), jax.random.PRNGKey(0))
    port = _flatten(synth.param_shapes(port_second_stage_spec(jspec)))
    want = {}
    for k, sd in _flatten(shapes).items():
        parts = k.split("/")
        if "enc_motion" in parts or "decoder" in parts or parts[-1] == "u":
            continue
        if parts[0] == "flow" and parts[3] == "steps":   # unstack the single step
            parts.insert(4, "0")
            sd = sd.shape[1:]
        else:
            sd = sd.shape
        want["/".join(parts)] = sd
    got = {k: v.shape for k, v in port.items()}
    assert got.keys() == want.keys()
    for k, shape in got.items():   # same element count (layouts differ)
        assert math.prod(shape) == math.prod(want[k]), k


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
