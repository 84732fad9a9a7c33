"""The port's conditioning towers and their trainers against the JAX package
on the CPU.

* ``init_wrapper`` with both halves and ``u``: JAX's draws (one jitted JAX
  init); ``wrapper_apply`` (the decoder), the encoder's variational draw
  (``rng`` and ``sample_prior``) and the spectral norm over the wrapper
  tree, each node normalised along its own O axis: within TOL of JAX's eager
  evaluation on the same params.
* The image AE's adaptive weight from one graph equals the definition's two
  fresh forwards; the AE optimizer is optax's ``adam(lr, 0.5, 0.9)`` under
  ``multi_transform`` (``u`` frozen): params within PARAM_TOL.
* Checkpoints: the port's ``AETrainState`` / ``PokeAEState`` trees are read
  by JAX's ``restore_like`` into JAX's own state structure, leaf for leaf;
  JAX's ``ckpt/io.save`` of that state is read back by the port bitwise.
* ``select_experiment`` and ``python -m ipoke_tpu_torch.main`` on tiny
  encoder configs: train, validate, keep the top-k, test the best.
* ``-m slow``: one image-AE step (deterministic and variational, gp_weight
  0 and 0.5) and one poke-AE step (``flow_ae``, ``poke_and_image``) against
  JAX's jitted step (~15 s to compile each): the logs and the gradients
  (twice Adam's first moment after one step of b1 0.5) within TOL, every
  updated ``w``, ``v``, ``g`` and ``u`` within PARAM_TOL, and the port's
  update of JAX's gradients within PARAM_TOL of JAX's params.  (A bias in
  front of a norm layer has a zero gradient up to rounding, which Adam's
  first step turns into +-lr: the update of the same gradients holds it.)
oneDNN is off for the port (its f32 CPU convs round coarser).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.models import discriminators as JD
from ipoke_tpu.models import encoders as je
from ipoke_tpu.nn.blocks import materialize_spectral_norm as jmaterialize
from ipoke_tpu.train import encoders as jte
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_wrapper, unbridge_wrapper
from ipoke_tpu_torch.experiments import select_experiment
from ipoke_tpu_torch.main import main as port_main
from ipoke_tpu_torch.models import encoders
from ipoke_tpu_torch.models.discriminators import PatchDiscSpec
from ipoke_tpu_torch.models.encoders import WrapperSpec
from ipoke_tpu_torch.train import encoders as te
from ipoke_tpu_torch.train.first_stage import trainable
from ipoke_tpu_torch.train.second_stage import float_leaves
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, flatten, jit_o0, np_tree

TOL = 2e-4          # tests/test_torch_gan.py: relative to 1 + max|ref|
PARAM_TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _specs(deterministic=False, nf_in=3, poke_and_image=False, s=16):
    kw = dict(nf_in=nf_in, nf_max=16, spatial_size=s, min_spatial_size=8,
              deterministic=deterministic, poke_and_image=poke_and_image)
    return je.WrapperSpec(**kw), WrapperSpec(**kw)


@pytest.fixture(scope="module")
def variational():
    """The variational image wrapper at 16^2: the port's init, its JAX tree,
    and a batch."""
    jspec, spec = _specs()
    params = encoders.init_wrapper(prng.prng_key(4), spec, CPU, train=True)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    return jspec, spec, params, unbridge_wrapper(params), x


def test_init_wrapper_draws_jax_params(variational):
    jspec, spec, params, jtree, _ = variational
    want = np_tree(jit_o0(lambda k: je.init_wrapper(k, jspec))(jax.random.PRNGKey(4)))
    got = flatten(jtree)
    assert got.keys() == flatten(want).keys()
    for k, w in flatten(want).items():
        _close(got[k], w, PARAM_TOL)
    back = flatten(bridge_wrapper(want, CPU))
    for k, v in flatten(params).items():
        _close(back[k], v, PARAM_TOL)
    # sampling trees: the encoder alone, drawn from the same first key, no u
    enc = flatten(encoders.init_wrapper(prng.prng_key(4), spec, CPU))
    assert all(not k.endswith("/u") for k in enc)
    assert all(torch.equal(v, flatten(params)[k]) for k, v in enc.items())


@pytest.mark.parametrize("draw", ["mean", "rng", "prior"])
def test_wrapper_apply_and_the_draw_match_jax(variational, draw):
    jspec, spec, params, jtree, x = variational
    rng = {"mean": None, "rng": 11, "prior": 12}[draw]
    jkey = None if rng is None else jax.random.PRNGKey(rng)
    pkey = None if rng is None else prng.prng_key(rng)
    want = je.conv_encoder_apply(jtree["encoder"], jnp.asarray(x), jspec.encoder_spec, rng=jkey,
                                 sample_prior=draw == "prior")
    got = encoders.conv_encoder_apply(params["encoder"], torch.from_numpy(x), spec.encoder_spec,
                                      rng=pkey, sample_prior=draw == "prior")
    for g, w in zip(got, want):
        _close(g.detach(), w)
    if draw != "prior":
        _close(encoders.wrapper_apply(params, torch.from_numpy(x), spec, pkey).detach(),
               je.wrapper_apply(jtree, jnp.asarray(x), jspec, jkey))


def test_spectral_norm_of_the_wrapper_matches_jax(variational):
    """Every kernel normalised along its O axis: the decoder's transpose
    convs (in, out, kh, kw) along axis 1, the rest along axis 0."""
    _, _, params, jtree, _ = variational
    got = flatten(unbridge_wrapper(encoders.materialize_spectral_norm(params)))
    want = flatten(np_tree(jmaterialize(jtree)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], w, PARAM_TOL)
    u0 = {k: v.clone() for k, v in flatten(params).items() if k.endswith("/u")}
    fresh = {k: v.detach().clone() for k, v in flatten(params).items()}
    copy = bridge_wrapper(unbridge_wrapper(params), CPU)
    encoders.refresh_spectral_u(copy)
    for k, v in flatten(copy).items():
        if k.endswith("/u"):
            assert not torch.equal(v, u0[k])
            _close(v, flatten(encoders.materialize_spectral_norm(params))[k], PARAM_TOL)
        else:
            assert torch.equal(v, fresh[k])


def _image_state(deterministic=False, gp=0.0, s=32, seed=3):
    spec = WrapperSpec(nf_in=3, nf_max=16, spatial_size=s, min_spatial_size=8,
                       deterministic=deterministic)
    disc = PatchDiscSpec(ndf=8, n_layers=2, gp_weight=gp)
    state, opts = te.init_image_ae(prng.prng_key(seed), spec, disc, lr=1e-3, device=CPU)
    return spec, disc, state, opts


def test_d_weight_on_one_graph_equals_two_fresh_forwards():
    """The adaptive weight's gradients at ``decoder.out_conv.conv.w`` taken
    on the step's one graph equal JAX's definition: fresh forwards of the
    NLL and of the adversarial loss with that weight substituted."""
    spec, disc, state, _ = _image_state()
    losses = te.ImageAELosses(spec, disc)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    _, logs = losses.gen_loss(state.params, state.disc_params, x, prng.prng_key(2))
    w = state.params["model"]["decoder"]["out_conv"]["conv"]["w"]

    def fresh(which):
        rec, _, _ = losses.reconstruct(state.params["model"], x, prng.prng_key(2))
        if which == "nll":
            return losses.nll_terms(x, rec, state.params["logvar"])[0]
        with torch.no_grad():
            dsn = te.blocks.materialize_spectral_norm(state.disc_params)
        return te.D.gen_loss(te.D.patch_disc_apply(dsn, rec, disc)[0])

    g_nll = torch.autograd.grad(fresh("nll"), w)[0]
    g_adv = torch.autograd.grad(fresh("adv"), w)[0]
    want = (g_nll.norm() / (g_adv.norm() + 1e-4)).clamp(0.0, 1e4)
    assert float(logs["d_weight"]) == pytest.approx(float(want), rel=1e-6)
    off = te.ImageAELosses(spec, disc, disc_active=False)
    assert float(off.gen_loss(state.params, state.disc_params, x, prng.prng_key(2))[1]["d_weight"]) == 0.0


def test_ae_optimizer_matches_optax():
    """Three updates of the same gradients: optax's ``adam(1e-3, 0.5, 0.9)``
    with ``u`` frozen, and the port's; ``u`` untouched."""
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "u": rng.normal(size=(4,)).astype(np.float32)},
            "logvar": np.float32(0.3)}
    grads = [{"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                    "u": np.zeros(4, np.float32)}, "logvar": np.float32(rng.normal())}
             for _ in range(3)]
    opt = jte.make_ae_optimizer(jax.tree_util.tree_map(jnp.asarray, tree), lr=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = opt.init(jp)
    port = {"a": {"w": torch.tensor(tree["a"]["w"]), "u": torch.tensor(tree["a"]["u"])},
            "logvar": torch.tensor(tree["logvar"])}
    popt = te.make_ae_optimizer(1e-3)
    ps = popt.init(trainable(port))
    for g in grads:
        up, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, up)
        leaves = float_leaves(trainable(port))
        upd = popt.update([torch.tensor(g["a"]["w"]), torch.tensor(g["logvar"])], ps, leaves)
        torch._foreach_add_(leaves, upd)
    _close(port["a"]["w"], jp["a"]["w"], PARAM_TOL)
    _close(port["logvar"], jp["logvar"], PARAM_TOL)
    assert torch.equal(port["a"]["u"], torch.tensor(tree["a"]["u"]))


def _jax_template(kind, spec, disc=None):
    """The structure of JAX's initial state, traced without running it."""
    if kind == "image":
        return jax.eval_shape(lambda k: jte.init_image_ae(k, spec, disc)[0], jax.random.PRNGKey(0))
    return jax.eval_shape(lambda k: jte.init_poke_ae(k, spec)[0], jax.random.PRNGKey(0))


@pytest.mark.parametrize("kind", ["image", "poke"])
def test_checkpoints_read_both_ways(tmp_path, kind):
    """The port's last.npz -> JAX's ``restore_like`` into JAX's state
    structure; JAX's save of that state -> the port's ``restore_*``, bitwise.
    (At 32^2: an encoder of one stage has no strided blocks, and neither
    package's npz keeps an empty list.)"""
    if kind == "image":
        spec, disc, state, opts = _image_state(s=32)
        step = te.make_image_ae_step(spec, disc, opts)
        jspec = je.WrapperSpec(nf_in=3, nf_max=16, spatial_size=32, min_spatial_size=8,
                               deterministic=False)
        template = _jax_template(kind, jspec, JD.PatchDiscSpec(ndf=8, n_layers=2))
        tree_of, restore = te.image_ae_ckpt_tree, te.restore_image_ae
        batch = {"images": torch.from_numpy(
            np.random.default_rng(0).uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32))}
    else:
        spec = WrapperSpec(nf_in=2, nf_max=16, spatial_size=32, min_spatial_size=8,
                           deterministic=True)
        state, opt = te.init_poke_ae(prng.prng_key(3), spec, device=CPU)
        step = te.make_poke_ae_step(spec, opt)
        jspec = je.WrapperSpec(nf_in=2, nf_max=16, spatial_size=32, min_spatial_size=8,
                               deterministic=True)
        template = _jax_template(kind, jspec)
        tree_of, restore = te.poke_ae_ckpt_tree, te.restore_poke_ae
        r = np.random.default_rng(0)
        batch = {"poke": torch.from_numpy(r.normal(size=(2, 32, 32, 2)).astype(np.float32)),
                 "flow": torch.from_numpy(r.normal(size=(2, 32, 32, 2)).astype(np.float32))}
    state, _ = step(state, batch, prng.prng_key(1))     # moments and u moved
    path = str(tmp_path / "last.npz")
    io.save(path, tree_of(state), metadata={"step": 1})
    loaded, _ = jio.load(path)
    restored = jio.restore_like(template, loaded)
    t_leaves = jax.tree_util.tree_leaves(template)
    r_leaves = jax.tree_util.tree_leaves(restored)
    assert len(t_leaves) == len(r_leaves)
    assert all(a.shape == b.shape for a, b in zip(t_leaves, r_leaves))
    jpath = str(tmp_path / "jax.npz")
    jio.save(jpath, restored._asdict())
    back = restore(io.load(jpath)[0], CPU)
    assert back.step == state.step == 1
    mine = flatten(tree_of(state))
    theirs = flatten(tree_of(back))
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        assert np.array_equal(np.asarray(v), np.asarray(theirs[k])), k


def test_select_experiment_dispatches_on_the_experiment():
    for name, mod in (("second_stage", "second_stage"), ("first_stage", "first_stage"),
                      ("img_encoder", "encoders"), ("poke_encoder", "encoders"),
                      ("distill", "distill")):
        exp = select_experiment({"general": {"experiment": name}}, {})
        assert exp.name == name and callable(exp.train) and callable(exp.test)
        assert exp.train.__closure__ is not None
        assert any(getattr(c.cell_contents, "__name__", "").endswith(mod)
                   for c in exp.train.__closure__)
    with pytest.raises(KeyError, match="unknown experiment"):
        select_experiment({"general": {"experiment": "gan"}}, {})


def _tiny_config(tmp_path, kind):
    src = "img_encoder.yaml" if kind == "img" else "poke_encoder.yaml"
    with open(os.path.join(ROOT, "configs", src)) as f:
        cfg = yaml.safe_load(f)
    s = 32 if kind == "img" else 16
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    cfg["data"].update(spatial_size=[s, s], max_frames=2, batch_size=2, n_examples=4,
                       n_workers=0, n_pokes=2, poke_size=3)
    cfg["architecture"]["nf_max"] = 16
    cfg["training"].update(n_epochs=1, max_batches_per_epoch=1, max_val_batches=1)
    cfg["logging"]["n_saved_ckpt"] = 2
    path = str(tmp_path / f"{kind}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("kind", ["img", "poke"])
def test_main_trains_and_tests_an_encoder(tmp_path, kind):
    """``python -m ipoke_tpu_torch.main``: one step and a validation with
    its top-k checkpoint; ``--test`` scores the best checkpoint again;
    ``--resume`` trains on from last.npz in the same version: step 2, its
    epoch's end validated."""
    cfg = _tiny_config(tmp_path, kind)
    run = port_main(["-c", cfg, "-m", "t", "--device", "cpu"])
    assert len(run["history"]) == 1 and len(run["val"]) == 1
    assert all(np.isfinite(v) for v in run["history"][0].values())
    kept = [f for f in os.listdir(run["ckpt_dir"]) if f.startswith("step=1-lpips-val=")]
    assert len(kept) == 1 and os.path.exists(run["ckpt"])
    tested = port_main(["-c", cfg, "-m", "t", "--device", "cpu", "--test", "fvd"])
    assert tested["lpips-val"] == pytest.approx(run["val"][0]["lpips-val"], rel=1e-6)
    again = port_main(["-c", cfg, "-m", "t", "--device", "cpu", "--resume", "--max-steps", "1"])
    assert again["ckpt_dir"] == run["ckpt_dir"] and again["start_step"] == 1
    assert again["state"].step == 2 and [v["step"] for v in again["val"]] == [2]


def test_main_raises_on_an_unported_test_mode(tmp_path, monkeypatch):
    """Every mode of JAX's ``--test`` is ported: ``accuracy`` reaches its
    function with the run's params; a mode JAX lacks is refused."""
    from ipoke_tpu_torch.eval import test_modes

    path = str(tmp_path / "s.yaml")
    with open(os.path.join(ROOT, "configs", "debug_second_stage.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["general"]["base_dir"] = str(tmp_path / "logs")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    seen = []
    monkeypatch.setitem(test_modes.MODES, "accuracy",
                        lambda params, spec, config, datamod, dirs, timings=None:
                        seen.append(config["general"]["test"]) or {"ran": True})
    assert port_main(["-c", path, "-m", "t", "--device", "cpu", "--test", "accuracy"]) == {"ran": True}
    assert seen == ["accuracy"]
    with pytest.raises(SystemExit):
        port_main(["-c", path, "-m", "t", "--device", "cpu", "--test", "nope"])


# ---------------------------------------------------------------------------
# whole steps against JAX's jitted ones (slow: a compile each)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("deterministic,gp", [(False, 0.0), (True, 0.0), (False, 0.5),
                                              (True, 0.5)])
def test_image_ae_step_matches_jax(deterministic, gp):
    jspec = je.WrapperSpec(nf_in=3, nf_max=16, spatial_size=16, min_spatial_size=8,
                           deterministic=deterministic)
    jdisc = JD.PatchDiscSpec(ndf=8, n_layers=2, gp_weight=gp)
    jstate, jopts = jte.init_image_ae(jax.random.PRNGKey(3), jspec, jdisc, lr=1e-3)
    spec, disc, state, opts = _image_state(deterministic, gp, s=16)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 16, 16, 3)).astype(np.float32)
    jnew, jlogs = jax.jit(jte.make_image_ae_step(jspec, jdisc, jopts))(
        jstate, {"images": jnp.asarray(x)}, jax.random.PRNGKey(5))
    new, logs = te.make_image_ae_step(spec, disc, opts)(
        state, {"images": torch.from_numpy(x)}, prng.prng_key(5))
    _check_step(jnew, jlogs, new, logs, te.image_ae_ckpt_tree,
                te.restore_image_ae(_as_saved(jstate), CPU), opts)


@pytest.mark.slow
@pytest.mark.parametrize("flow_ae,poke_and_image", [(False, False), (True, False),
                                                    (False, True)])
def test_poke_ae_step_matches_jax(flow_ae, poke_and_image):
    kw = dict(nf_in=2, nf_max=16, spatial_size=16, min_spatial_size=8, deterministic=True,
              poke_and_image=poke_and_image)
    jspec, spec = je.WrapperSpec(**kw), WrapperSpec(**kw)
    jstate, jopt = jte.init_poke_ae(jax.random.PRNGKey(3), jspec, lr=1e-3)
    state, opt = te.init_poke_ae(prng.prng_key(3), spec, lr=1e-3, device=CPU)
    r = np.random.default_rng(0)
    batch = {"poke": r.normal(size=(2, 16, 16, 2)).astype(np.float32),
             "flow": r.normal(size=(2, 16, 16, 2)).astype(np.float32),
             "images": r.uniform(-1, 1, (2, 2, 16, 16, 3)).astype(np.float32)}
    jnew, jlogs = jax.jit(jte.make_poke_ae_step(jspec, jopt, flow_ae=flow_ae))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, logs = te.make_poke_ae_step(spec, opt, flow_ae=flow_ae)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _check_step(jnew, jlogs, new, logs, te.poke_ae_ckpt_tree,
                te.restore_poke_ae(_as_saved(jstate), CPU), {"gen": opt})


def _as_saved(state):
    """A JAX train state as its npz holds it: plain dicts and lists of numpy."""
    return np_tree(jio._unflatten(jio._flatten(jax.device_get(state._asdict()))))


def _check_step(jnew, jlogs, new, logs, tree_of, start, opts):
    """The logs and gradients within TOL; the updated w, v, g, u within
    PARAM_TOL; the port's optimizer on JAX's gradients from JAX's start
    gives JAX's params within PARAM_TOL."""
    for k in jlogs:
        _close(float(logs[k]), float(jlogs[k]))
    want = flatten(_as_saved(jnew))
    got = flatten(tree_of(new))
    assert got.keys() == want.keys()
    for k, w in want.items():
        leaf = k.rsplit("/", 1)[-1]
        if "/mu/" in k:
            _close(2 * np.asarray(got[k]), 2 * np.asarray(w))     # the gradients
        elif k.split("/")[0] in ("params", "disc_params") and leaf in ("w", "v", "g", "u"):
            _close(got[k], w, PARAM_TOL)
    jback = te.restore_image_ae if isinstance(new, te.AETrainState) else te.restore_poke_ae
    jtrained = jback(_as_saved(jnew), CPU)
    pairs = [("params", "opt_state", "gen")]
    if isinstance(new, te.AETrainState):
        pairs.append(("disc_params", "disc_opt_state", "disc"))
    for p_name, o_name, opt_name in pairs:
        params = getattr(start, p_name)
        grads = [2 * m for m in getattr(jtrained, o_name)[0]["mu"]]
        leaves = float_leaves(trainable(params))
        with torch.no_grad():
            torch._foreach_add_(leaves, opts[opt_name].update(grads, getattr(start, o_name), leaves))
        want_leaves = float_leaves(trainable(getattr(jtrained, p_name)))
        for a, b in zip(leaves, want_leaves):
            _close(a.detach(), b.detach(), PARAM_TOL)
