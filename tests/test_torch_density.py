"""The port's density direction against the JAX package on the CPU: the
motion encoder, ``encode_first_stage`` and ``forward_density`` (out, logdet)
within 2e-4·(1+max|ref|), the flow losses (``reference_nll_loss`` included)
within 1e-5, and actnorm's ``data_init`` within 1e-5.

The tiny second stage of tests/test_torch_serve.py's config (64x64, 3
frames, 8x8 latent) is drawn by the port's ``init`` (JAX's numbers) with the
flow's output gains set non-zero, so no coupling is the identity, and carried
to JAX's layout by ``ckpt/jax_bridge.unbridge_second_stage``; every JAX
reference comes from one jitted function."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.flows import actnorm as jactnorm
from ipoke_tpu.flows import loss as jloss
from ipoke_tpu.models import motion_encoder as jme
from ipoke_tpu.models import second_stage as jss
from ipoke_tpu_torch.ckpt.jax_bridge import unbridge_second_stage
from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
from ipoke_tpu_torch.flows import actnorm, loss
from ipoke_tpu_torch.models import motion_encoder, second_stage
from ipoke_tpu_torch.utils import prng, synth
from torch_port_util import CPU, port_second_stage_spec, t, tiny_config

DENSITY_TOL = 2e-4   # the slice's f32 tolerance, relative to 1 + max|ref|
LOSS_TOL = 1e-5
B, T, S = 2, 3, 64
LOSS_KEY = 9


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * (1 + float(np.abs(ref).max())), err


def density_model(seed=1, gain=0.05):
    """(port params, port spec, JAX params, JAX spec, numpy batch)."""
    from ipoke_tpu.experiments.second_stage import build_spec_from_config as jax_build_spec

    cfg = tiny_config("unused", spatial=S, frames=T)
    spec = build_spec_from_config(cfg, mcf_backend="scan")
    jspec = jax_build_spec(cfg)
    assert port_second_stage_spec(jspec, mcf_backend="scan") == spec
    pt = second_stage.init(prng.prng_key(seed), spec, device=CPU)
    pt["flow"] = synth.set_flow_output_gains(pt["flow"], gain)
    pj = jax.tree_util.tree_map(jnp.asarray, unbridge_second_stage(pt, spec))
    rng = np.random.default_rng(seed)
    batch = {"images": rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32),
             "poke": rng.standard_normal((B, S, S, 2)).astype(np.float32)}
    return pt, spec, pj, jspec, batch


@pytest.fixture(scope="module")
def model():
    pt, spec, pj, jspec, batch = density_model()

    @jax.jit
    def reference(p, b):
        enc = jme.apply(p["first_stage"]["enc_motion"], b["images"], jspec.first_stage.encoder_spec)
        out, logdet, cond = jss.forward_density(p, jspec, b)
        key = jax.random.PRNGKey(LOSS_KEY)
        losses = {sm: jloss.flow_loss(out, logdet, key=key, spatial_mean=sm, logdet_weight=0.7)
                  for sm in (False, True)}
        x = p["flow"]["levels"][0]["steps"]["actnorm1"]
        an = jactnorm.data_init(jax.tree_util.tree_map(lambda a: a[0], x), out)
        return {"enc": enc, "density": (out, logdet, cond), "losses": losses,
                "logp": jloss.gaussian_logp_loss(out, logdet), "data_init": an}

    ref = reference(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    return pt, spec, {k: t(v) for k, v in batch.items()}, ref


def test_motion_encoder_matches_jax(model):
    pt, spec, batch, ref = model
    got = motion_encoder.apply(pt["first_stage"]["enc_motion"], batch["images"],
                               spec.first_stage.encoder_spec)
    for g, r in zip(got, ref["enc"]):
        _close(g, r, DENSITY_TOL)
    motion, mu = second_stage.encode_first_stage(pt, spec, batch["images"])
    _close(motion, ref["enc"][0], DENSITY_TOL)
    assert torch.equal(motion, mu) and not motion.requires_grad


@pytest.mark.parametrize("full_seq,full_sequence,frames", [
    (True, True, slice(None)), (True, False, slice(None)),   # fewer than 16 frames: all
    (False, True, slice(None)), (False, False, slice(1, None))])
def test_encode_first_stage_frame_range(model, full_seq, full_sequence, frames):
    """The reference's choice of frames (``models/second_stage.py``)."""
    pt, spec, batch, _ = model
    s = dataclasses.replace(spec, full_seq=full_seq, first_stage=dataclasses.replace(
        spec.first_stage, full_sequence=full_sequence))
    motion, _ = second_stage.encode_first_stage(pt, s, batch["images"])
    want, _, _ = motion_encoder.apply(pt["first_stage"]["enc_motion"], batch["images"][:, frames],
                                      s.first_stage.encoder_spec)
    assert torch.equal(motion, want)


def test_forward_density_matches_jax(model):
    pt, spec, batch, ref = model
    out, logdet, cond = second_stage.forward_density(pt, spec, batch)
    r_out, r_logdet, r_cond = ref["density"]
    assert logdet.dtype == torch.float32 and logdet.shape == (B,)
    _close(cond, r_cond, DENSITY_TOL)
    _close(out, r_out, DENSITY_TOL)
    _close(logdet, r_logdet, DENSITY_TOL)
    assert float(np.abs(np.asarray(r_logdet)).max()) > 1.0   # the couplings are not the identity


@pytest.mark.parametrize("spatial_mean", [False, True])
def test_flow_loss_matches_jax(model, spatial_mean):
    pt, spec, batch, ref = model
    out, logdet, _ = second_stage.forward_density(pt, spec, batch)
    r_out, r_logdet, _ = ref["density"]
    # on JAX's own (out, logdet), so only the loss itself is compared
    out, logdet = t(r_out), t(r_logdet)
    total, logs = loss.flow_loss(out, logdet, key=prng.prng_key(LOSS_KEY),
                                 spatial_mean=spatial_mean, logdet_weight=0.7)
    r_total, r_logs = ref["losses"][spatial_mean]
    assert logs.keys() == r_logs.keys()
    _close(total, r_total, LOSS_TOL)
    for k in r_logs:
        _close(logs[k], r_logs[k], LOSS_TOL)
    r_loss, r_logp = ref["logp"]
    total, logp = loss.gaussian_logp_loss(out, logdet)
    _close(total, r_loss, LOSS_TOL)
    for k in r_logp:
        _close(logp[k], r_logp[k], LOSS_TOL)


def test_actnorm_data_init_matches_jax(model):
    pt, _, _, ref = model
    x = t(ref["density"][0])
    got = actnorm.data_init(pt["flow"]["levels"][0]["steps"][0]["actnorm1"], x)
    for k in ("log_scale", "bias"):
        _close(got[k], ref["data_init"][k], LOSS_TOL)
    out, _ = actnorm.forward(got, x)
    flat = out.reshape(-1, out.shape[-1])
    np.testing.assert_allclose(flat.mean(0).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(flat.std(0).numpy(), 1, atol=1e-4)
