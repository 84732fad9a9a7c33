"""The stage-1 model variants and the ``poke_vae`` baseline trainer, the
port against the JAX package on the CPU.

* ``poke_vae_forward`` (both ``stack_motion_and_poke`` settings, the
  posterior draw and ``sample_prior``), ``rnn_motion_forward`` and
  ``fc_baseline_forward`` on the spectral-normed trees against JAX's, and
  the PokeVAE's gradients of an L1 + KL loss against ``jax.grad``: within
  2e-4·(1+max|ref|).  The spectral norm goes through
  ``models/first_stage.materialize_spectral_norm`` on the port's side and
  JAX's generic walk on JAX's, so a conv normalised along the wrong axis
  (the decoder's transpose convs, the poke encoder) shows.
* The bridge both ways on each variant tree, ``u`` kept.
* The trainer with ``architecture.baseline: poke_vae`` on the CPU: two
  steps, a validation and its checkpoints, ``last.npz`` read by JAX's
  ``ckpt/io`` and restored bitwise, ``test`` on the best checkpoint, JAX's
  forward on the saved generator, and the KeyError without a checkpoint.
* ``slow``: each variant's init against JAX's own draws (JAX's eager init
  takes ~16-19 s here), and one GAN step with the PokeVAE forward against
  JAX's jitted ``make_gan_train_step(forward_fn=...)``.

Params come from the port's init (JAX's draws) carried to JAX's layout by
``ckpt/jax_bridge.unbridge_generator``, with numpy noise added so no
layer is at its init.  oneDNN is off, as in tests/test_torch_gan.py."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.models import encoders as jencoders
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.models import motion_encoder as jmotion_encoder
from ipoke_tpu.models import variants as jvariants
from ipoke_tpu.nn.blocks import materialize_spectral_norm as jmaterialize
from ipoke_tpu.train.losses import kl_divergence as jkl
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import (bridge_gan_params, bridge_generator,
                                             unbridge_generator)
from ipoke_tpu_torch.config import load_parameters
from ipoke_tpu_torch.experiments import first_stage as experiment
from ipoke_tpu_torch.models import first_stage as pfs
from ipoke_tpu_torch.models import variants
from ipoke_tpu_torch.train import first_stage as tfs
from ipoke_tpu_torch.train.losses import kl_divergence
from ipoke_tpu_torch.train.second_stage import float_leaves
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, clone_tree, flatten, jit_o0, np_tree, t

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
B, T, S = 2, 3, 32
# GroupNorm's 16 groups set the least widths: the poke encoder's nf_max is
# z_dim, the RNN model's ConvDecoder normalises every block
FS = dict(z_dim=16, spatial_size=S, max_frames=T, enc_channels=(16,) * 4, dec_channels=(16,) * 4,
          n_gru_layers=2, min_spatial_size=4, motion_bias=True, full_sequence=True)
FS_SPEC, JFS_SPEC = pfs.FirstStageSpec(**FS), jfs.FirstStageSpec(**FS)
FC = dict(z_dim=16, spatial_size=S, max_frames=T, enc_channels=(16,) * 4, dec_channels=(16,) * 4)


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (1 + np.abs(want).max()))


def _noisy(tree, seed, scale=0.02):
    """A port tree with N(0, scale) added to every float leaf but ``u``."""
    rng = np.random.default_rng(seed)

    def walk(x, name=""):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, name) for v in x]
        if name == "u":
            return x
        return x + scale * t(rng.standard_normal(tuple(x.shape)))

    return walk(tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, unbridge_generator(tree))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32),
            "poke": rng.standard_normal((B, S, S, 2)).astype(np.float32)}


def _pv_specs(stack):
    return (variants.PokeVAESpec(FS_SPEC, stack), jvariants.PokeVAESpec(JFS_SPEC, stack))


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prior", [False, True], ids=["posterior", "prior"])
@pytest.mark.parametrize("stack", [False, True], ids=["poke_in", "stacked"])
def test_poke_vae_forward_matches_jax(stack, prior):
    spec, jspec = _pv_specs(stack)
    p = _noisy(variants.init_poke_vae(prng.prng_key(1), spec), 2)
    batch = _batch(3)
    with torch.no_grad():
        got = variants.poke_vae_forward(pfs.materialize_spectral_norm(p),
                                        {k: t(v) for k, v in batch.items()}, spec,
                                        rng=prng.prng_key(4), sample_prior=prior)
    want = jit_o0(lambda p_, b_: jvariants.poke_vae_forward(
        jmaterialize(p_), b_, jspec, rng=jax.random.PRNGKey(4), sample_prior=prior))(_jax(p), batch)
    assert got[0].shape == (B, T - 1, S, S, 3)
    if prior:
        assert got[1] is None and got[2] is None and want[1] is None
        assert bool(torch.isfinite(got[0]).all()) and float(got[0].abs().max()) <= 1.0
    for g, w in zip(got, want):
        if w is not None:
            assert _err(g, w) <= TOL


def test_poke_vae_gradients_match_jax():
    """d(L1 + KL)/d params through the spectral norm and the posterior draw,
    every trainable leaf (``u`` takes none)."""
    spec, jspec = _pv_specs(True)
    p = _noisy(variants.init_poke_vae(prng.prng_key(5), spec), 6)
    batch = _batch(7)

    def jloss(p_, b_):
        x_hat, mu, logvar = jvariants.poke_vae_forward(jmaterialize(p_), b_, jspec,
                                                       rng=jax.random.PRNGKey(8))
        return jnp.mean(jnp.abs(b_["images"][:, 1:] - x_hat)) + 0.1 * jkl(mu, logvar)

    want = flatten(tfs.trainable(bridge_generator(np_tree(jit_o0(jax.grad(jloss))(_jax(p), batch)),
                                                  CPU)))
    for leaf in float_leaves(tfs.trainable(p)):
        leaf.requires_grad_(True)
    x_hat, mu, logvar = variants.poke_vae_forward(pfs.materialize_spectral_norm(p),
                                                  {k: t(v) for k, v in batch.items()}, spec,
                                                  rng=prng.prng_key(8))
    loss = (t(batch["images"])[:, 1:] - x_hat).abs().mean() + 0.1 * kl_divergence(mu, logvar)
    leaves = float_leaves(tfs.trainable(p))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)   # motion_bias is unread
    got = {k: torch.zeros_like(v) if g is None else g
           for (k, v), g in zip(flatten(tfs.trainable(p)).items(), grads)}
    assert got.keys() == want.keys() and len(got) > 50
    errs = {k: _err(g, want[k]) for k, g in got.items()}
    assert max(errs.values()) <= TOL, max(errs.items(), key=lambda kv: kv[1])


def test_rnn_motion_forward_matches_jax():
    p, enc_spec, dec_spec = variants.init_rnn_motion(prng.prng_key(9), FS_SPEC)
    p = _noisy(p, 10)
    jenc, jdec = (jencoders.ConvEncoderSpec(**dataclasses.asdict(enc_spec)),
                  jencoders.ConvDecoderSpec(**dataclasses.asdict(dec_spec)))
    x = _batch(11)["images"]
    with torch.no_grad():
        got = variants.rnn_motion_forward(pfs.materialize_spectral_norm(p), t(x), FS_SPEC,
                                          enc_spec, dec_spec, rng=prng.prng_key(12))
    want = jit_o0(lambda p_, x_: jvariants.rnn_motion_forward(
        jmaterialize(p_), x_, JFS_SPEC, jenc, jdec, rng=jax.random.PRNGKey(12)))(_jax(p), x)
    assert got[0].shape == (B, T - 1, S, S, 3)
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL


def test_fc_baseline_forward_matches_jax():
    spec, jspec = variants.FCBaselineSpec(**FC), jvariants.FCBaselineSpec(**FC)
    p, me_spec = variants.init_fc_baseline(prng.prng_key(13), spec)
    p = _noisy(p, 14)
    x = _batch(15)["images"]
    with torch.no_grad():
        got = variants.fc_baseline_forward(pfs.materialize_spectral_norm(p), t(x), spec, me_spec,
                                           rng=prng.prng_key(16))
    jme = jmotion_encoder.MotionEncoderSpec(**dataclasses.asdict(me_spec))
    want = jit_o0(lambda p_, x_: jvariants.fc_baseline_forward(
        jmaterialize(p_), x_, jspec, jme, rng=jax.random.PRNGKey(16)))(_jax(p), x)
    assert got[0].shape == (B, T - 1, S, S, 3)
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["poke_vae", "poke_vae_stacked", "rnn_motion", "fc_baseline"])
def test_variant_tree_bridges_both_ways(model):
    """unbridge -> bridge (and through the GAN pair as gen_params) gives the
    tree back bitwise, ``u`` included; the JAX-layout leaves have the shapes
    of JAX's init."""
    key, jkey = prng.prng_key(0), jax.random.PRNGKey(0)
    port, jshapes = {
        "poke_vae": lambda: (variants.init_poke_vae(key, _pv_specs(False)[0]),
                             lambda k: jvariants.init_poke_vae(k, _pv_specs(False)[1])),
        "poke_vae_stacked": lambda: (variants.init_poke_vae(key, _pv_specs(True)[0]),
                                     lambda k: jvariants.init_poke_vae(k, _pv_specs(True)[1])),
        "rnn_motion": lambda: (variants.init_rnn_motion(key, FS_SPEC)[0],
                               lambda k: jvariants.init_rnn_motion(k, JFS_SPEC)[0]),
        "fc_baseline": lambda: (variants.init_fc_baseline(key, variants.FCBaselineSpec(**FC))[0],
                                lambda k: jvariants.init_fc_baseline(
                                    k, jvariants.FCBaselineSpec(**FC))[0]),
    }[model]()
    jt = unbridge_generator(port)
    with jax.ensure_compile_time_eval():   # JAX's RNN init takes an int of jnp.log2
        shapes = flatten(jax.eval_shape(lambda k: jshapes(k), jkey))
    assert {k: v.shape for k, v in flatten(jt).items()} == {k: v.shape for k, v in shapes.items()}
    for back in (bridge_generator(jt, CPU),
                 bridge_gan_params({"gen_params": jt}, CPU)["gen_params"]):
        a, b = flatten(port), flatten(back)
        assert a.keys() == b.keys() and any(k.endswith("/u") for k in a)
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _config(tmp_path, stack):
    cfg = yaml.safe_load((ROOT / "configs" / "first_stage.yaml").read_text())
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    cfg["data"].update({"batch_size": B, "n_examples": 2 * B, "max_frames": T, "spatial_size": [S, S],
                        "n_workers": 0})
    cfg["architecture"].update({"ENC_M_channels": list(FS["enc_channels"]), "z_dim": FS["z_dim"],
                                "dec_channels": [16, 8, 8, 8], "n_gru_layers": 1,
                                "min_spatial_size": 4, "baseline": "poke_vae",
                                "stack_motion_and_poke": stack})
    cfg["training"].update({"n_epochs": 1, "max_batches_per_epoch": 2, "max_val_batches": 1})
    cfg["d_s"]["n_examples"] = 2
    cfg["logging"]["n_samples_fvd"] = B
    path = tmp_path / "poke_vae.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_poke_vae_trainer(tmp_path):
    """Two steps of the stacked PokeVAE under the GAN recipe, the epoch's
    validation and checkpoints; ``last.npz`` in JAX's layout restores to
    the trained state bitwise; JAX's forward on the saved generator equals
    the port's; ``test`` validates the best checkpoint; without a
    checkpoint ``test`` raises KeyError, as JAX's fails on its fallback."""
    path = _config(tmp_path, stack=True)
    config, dirs = load_parameters(str(path), "pv")
    run = experiment.train(config, dirs, device=CPU)
    state = run["state"]
    assert state.step == 2 and len(run["history"]) == 2 and [v["step"] for v in run["val"]] == [2]
    assert all(np.isfinite(v) for h in run["history"] for v in h.values())
    assert set(state.gen_params) == {"enc_motion", "poke_enc", "rnn", "motion_bias", "gen"}
    assert state.gen_params["rnn"][0]["out"]["w"].shape[0] == 2 * FS["z_dim"]   # stacked hidden
    fs_spec = experiment.specs_from_config(config)[0]
    start = variants.init_poke_vae(prng.prng_key(config["general"]["seed"] + 1),
                                   experiment.poke_vae_spec(config, fs_spec))
    now, then = flatten(state.gen_params), flatten(start)
    moved = [k for k in then if not k.endswith("/u") and not torch.equal(now[k].detach(), then[k])]
    assert len(moved) == sum(not k.endswith("/u") for k in then)
    assert all(torch.equal(now[k], then[k]) for k in then if k.endswith("/u"))

    tree, meta = jio.load(run["ckpt"])   # JAX reads the port's last.npz
    assert meta["step"] == 2 and "u" in tree["gen_params"]["poke_enc"]["stem"]["conv"]
    template = tfs.GanTrainState(0, *(clone_tree(getattr(state, f"{n}_params")) for n in tfs.NETS),
                                 state.gen_opt, state.ds_opt, state.dt_opt)
    opts = {n: tfs.make_gan_optimizer(2e-4) for n in tfs.NETS}
    back = experiment.restore_gan_state(io.load(run["ckpt"])[0], opts, template, CPU)
    assert back.step == 2
    for n in tfs.NETS:
        a, b = flatten(getattr(back, f"{n}_params")), flatten(getattr(state, f"{n}_params"))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k].detach()) for k in a), n
        for sa, sb in zip(getattr(back, f"{n}_opt"), getattr(state, f"{n}_opt")):
            assert flatten(sa).keys() == flatten(sb).keys()
            for k, x in flatten(sa).items():
                y = flatten(sb)[k]
                assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), (n, k)

    images, poke = _batch(17)["images"], _batch(17)["poke"]
    spec, jspec = experiment.poke_vae_spec(config, fs_spec), jvariants.PokeVAESpec(
        jfs.FirstStageSpec(**dataclasses.asdict(fs_spec)), True)
    want = jit_o0(lambda p_, b_: jvariants.poke_vae_forward(
        jmaterialize(p_), b_, jspec, rng=jax.random.PRNGKey(18)))(
        jax.tree_util.tree_map(jnp.asarray, tree["gen_params"]), {"images": images, "poke": poke})
    with torch.no_grad():
        got = variants.poke_vae_forward(pfs.materialize_spectral_norm(state.gen_params),
                                        {"images": t(images), "poke": t(poke)}, spec,
                                        rng=prng.prng_key(18))
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL

    tested = experiment.test(config, dirs, device=CPU)
    val = run["val"][0]
    assert all(abs(tested[k] - val[k]) <= 1e-5 * (1 + abs(val[k])) for k in tested), (tested, val)
    empty, edirs = load_parameters(str(path), "none")
    with pytest.raises(KeyError, match="poke_enc"):
        experiment.test(empty, edirs, device=CPU)


# ---------------------------------------------------------------------------
# slow: the inits against JAX's draws, one GAN step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("model", ["poke_vae", "poke_vae_stacked", "rnn_motion", "fc_baseline"])
def test_variant_init_matches_jax(model):
    key, jkey = prng.prng_key(21), jax.random.PRNGKey(21)
    port, ref = {
        "poke_vae": lambda: (variants.init_poke_vae(key, _pv_specs(False)[0]),
                             jvariants.init_poke_vae(jkey, _pv_specs(False)[1])),
        "poke_vae_stacked": lambda: (variants.init_poke_vae(key, _pv_specs(True)[0]),
                                     jvariants.init_poke_vae(jkey, _pv_specs(True)[1])),
        "rnn_motion": lambda: (variants.init_rnn_motion(key, FS_SPEC)[0],
                               jvariants.init_rnn_motion(jkey, JFS_SPEC)[0]),
        "fc_baseline": lambda: (variants.init_fc_baseline(key, variants.FCBaselineSpec(**FC))[0],
                                jvariants.init_fc_baseline(jkey,
                                                           jvariants.FCBaselineSpec(**FC))[0]),
    }[model]()
    a, b = flatten(unbridge_generator(port)), flatten(np_tree(ref))
    assert a.keys() == b.keys()
    for k in a:
        assert _err(a[k], b[k]) <= 1e-6, k


@pytest.mark.slow
def test_poke_vae_gan_step_matches_jax_jitted_step():
    """One step of the stage-1 GAN recipe with the PokeVAE forward against
    JAX's jitted ``make_gan_train_step(forward_fn=...)``, both with an
    optimizer whose updates are the gradients: every gradient leaf of the
    three nets and every metric within 2e-4·(1+|ref|)."""
    import optax

    from ipoke_tpu.models import discriminators as JD
    from ipoke_tpu.train import first_stage as jtfs
    from ipoke_tpu_torch.models import discriminators as D
    from ipoke_tpu_torch.train.second_stage import Optimizer
    from test_torch_first_stage import _GradsAsUpdates
    from torch_port_util import GAN_DS, GAN_DT, random_like

    # the decoder narrowed to the first stage's test width (torch_port_util.GAN_FS):
    # at 16 wide, JAX's own f32 gradients stray from float64 beyond the tolerance
    narrow = dict(FS, dec_channels=(16, 8, 8, 8), n_gru_layers=1)
    spec = variants.PokeVAESpec(pfs.FirstStageSpec(**narrow))
    jspec = jvariants.PokeVAESpec(jfs.FirstStageSpec(**narrow))
    ds, dt = D.PatchDiscSpec(**GAN_DS), D.TempDiscSpec(**dict(GAN_DT, sequence_length=T))
    jds, jdt = JD.PatchDiscSpec(**GAN_DS), JD.TempDiscSpec(**dict(GAN_DT, sequence_length=T))
    jkey = jax.random.PRNGKey(0)
    nets = {"gen_params": unbridge_generator(_noisy(variants.init_poke_vae(prng.prng_key(1), spec),
                                                    2)),
            "ds_params": random_like(jax.eval_shape(lambda: JD.init_patch_disc(jkey, jds)), 3),
            "dt_params": random_like(jax.eval_shape(lambda: JD.init_temp_disc(jkey, jdt)), 4)}
    batch = _batch(5)

    def grads_as_updates(params):
        return optax.multi_transform(
            {"train": optax.GradientTransformation(lambda p: optax.EmptyState(),
                                                   lambda g, s, p=None: (g, s)),
             "freeze": optax.set_to_zero()}, jtfs._label_tree(params))

    jopts = {n: grads_as_updates(nets[f"{n}_params"]) for n in tfs.NETS}
    jnets = jax.tree_util.tree_map(jnp.asarray, nets)
    jstate = jtfs.GanTrainState(jnp.zeros((), jnp.int32), jnets["gen_params"], jnets["ds_params"],
                                jnets["dt_params"],
                                *(jopts[n].init(jnets[f"{n}_params"]) for n in tfs.NETS))
    jstep = jax.jit(jtfs.make_gan_train_step(
        jspec.first_stage, jds, jdt, jopts, n_spatial_examples=2,
        forward_fn=lambda p, b, k: jvariants.poke_vae_forward(p, b, jspec, rng=k)))
    new, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(21))

    port = bridge_gan_params(np_tree(nets), CPU)
    for p in port.values():
        for leaf in float_leaves(tfs.trainable(p)):
            leaf.requires_grad_(True)
    opts = {n: Optimizer([_GradsAsUpdates()]) for n in tfs.NETS}
    state = tfs.GanTrainState(0, port["gen_params"], port["ds_params"], port["dt_params"],
                              *(opts[n].init(tfs.trainable(port[f"{n}_params"])) for n in tfs.NETS))
    start = {n: flatten(clone_tree(tfs.trainable(port[f"{n}_params"]))) for n in tfs.NETS}
    step = tfs.make_gan_train_step(
        spec.first_stage, ds, dt, opts, n_spatial_examples=2,
        forward_fn=lambda p, b, k: variants.poke_vae_forward(p, b, spec, rng=k))
    state, got_metrics = step(state, {k: t(v) for k, v in batch.items()}, prng.prng_key(21))
    after = bridge_gan_params(np_tree({f"{n}_params": getattr(new, f"{n}_params")
                                       for n in tfs.NETS}), CPU)
    before = bridge_gan_params(np_tree(nets), CPU)
    errs = []
    for n in tfs.NETS:
        now = flatten(tfs.trainable(getattr(state, f"{n}_params")))
        for k, v in flatten(tfs.trainable(after[f"{n}_params"])).items():
            want = v - flatten(tfs.trainable(before[f"{n}_params"]))[k]
            errs.append((_err(now[k].detach() - start[n][k], want.numpy()), n, k))
    assert max(errs)[0] <= TOL, max(errs)
    for k, v in metrics.items():
        assert abs(float(got_metrics[k]) - float(v)) <= TOL * (1 + abs(float(v))), k
