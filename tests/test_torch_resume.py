"""Training resumption, the run log, checkpoint-on-signal and
``training.chunked`` of the port against the JAX package on the CPU.

* optax's state layout (``ckpt/optax_layout``): for every chain the
  trainers build (stage 2's ``make_optimizer`` variants, the students'
  ``adam``, stage 1's GAN chain, the AE chain), JAX's ``restore_like`` of
  the port's saved tree into JAX's own state structure gives the port's
  leaves bitwise, and the port reads JAX's ``ckpt/io.save`` of that state
  back to the same state bitwise.  JAX's templates are traced with
  ``jax.eval_shape`` of optax's ``init``: no JAX compile.
* The same through ``Experiment.maybe_resume`` of every experiment (stage
  2, chunked stage 2, stage 1, both students, both AEs): JAX's reads the
  port's ``last.npz`` without its "training fresh" branch, and the port's
  ``experiments/base.maybe_resume`` reads JAX's.
* ``metrics.jsonl``: the records of the port's ``fit`` against JAX's
  ``Experiment.fit`` driven with the same scripted step and validation
  (``log_every``, validations, a resumed step counter): steps and keys
  equal, values within 1e-6.  The run logger's media files and its
  fallback without wandb against JAX's.
* SIGTERM/SIGINT raised inside step k: both packages return after step k
  with ``last.npz`` metadata ``{"step": k, "preempted": True}`` and the
  handler found before restored.
* Resume on the tiny second stage: the step counter goes on, the key and the
  epoch restart, the lr is the schedule's at the saved count; ``python -m
  ipoke_tpu_torch.main --resume --device cpu`` on the debug config; a
  config of other widths raises and leaves the run's checkpoints as they
  were.
* ``training.chunked``: only ``flow`` trains, the optimizer ignores clip,
  adabelief, adamw and amsgrad, the checkpoint is JAX's
  ``ChunkedTrainState``; ``-m slow``: one step against JAX's
  ``make_chunked_trainer`` within 2e-4·(1+max|ref|).
"""
import os
import signal
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.experiments.base import Experiment
from ipoke_tpu.models import discriminators as JD
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.train import chunked as jchunked
from ipoke_tpu.train import first_stage as jtrain_fs
from ipoke_tpu.train import second_stage as jtrain
from ipoke_tpu.utils.logging import RunLogger as JaxRunLogger
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import (
    bridge_direct, bridge_flow, bridge_gan_params, bridge_second_stage, unbridge_direct,
    unbridge_flow, unbridge_gan_params, unbridge_second_stage)
from ipoke_tpu_torch.ckpt.optax_layout import from_optax, to_optax
from ipoke_tpu_torch.experiments import base
from ipoke_tpu_torch.experiments import distill as exp_distill
from ipoke_tpu_torch.experiments import encoders as exp_enc
from ipoke_tpu_torch.experiments import first_stage as exp_fs
from ipoke_tpu_torch.experiments import second_stage as experiment
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.main import main as port_main
from ipoke_tpu_torch.models import second_stage as pss
from ipoke_tpu_torch.train import distill
from ipoke_tpu_torch.train import encoders as te
from ipoke_tpu_torch.train import first_stage as train_fs
from ipoke_tpu_torch.train import lr
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.logging import RunLogger, get_logger, read_metrics
from test_torch_encoders import _image_state
from torch_port_util import CPU, GAN_DS, GAN_DT, GAN_FS, flatten, random_like, tiny_config

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, weight_decay=1e-2, warmup_steps=2, total_steps=10)
STAGE2 = {
    "torch_adam": {},
    "torch_adam_no_decay": {"weight_decay": 0.0},
    "amsgrad": {"amsgrad": True},
    "amsgrad_no_decay": {"amsgrad": True, "weight_decay": 0.0},
    "adamw": {"use_adamw": True},
    "adabelief": {"use_adabelief": True},
    "clip": {"clip_grad_norm": 1.0},
    "clip_no_decay": {"clip_grad_norm": 1.0, "weight_decay": 0.0},
    "clip_amsgrad": {"clip_grad_norm": 1.0, "amsgrad": True},
    "clip_adamw": {"clip_grad_norm": 1.0, "use_adamw": True},
    "clip_adabelief": {"clip_grad_norm": 1.0, "use_adabelief": True},
}
METRICS_TOL = 1e-6


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(spec, the port's trainable params) of the tiny second stage."""
    spec = experiment.build_spec_from_config(tiny_config("unused", spatial=64, frames=3),
                                             mcf_backend="scan")
    params = pss.init(prng.prng_key(0), spec, CPU)
    return spec, train_ss.split_params(params)[0]


def _advance(opt, state, params, steps=2, seed=0):
    """``steps`` updates of ``opt`` on seeded gradients (moments and counts
    move; the params do not)."""
    g = torch.Generator().manual_seed(seed)
    leaves = train_ss.float_leaves(train_fs.trainable(params))
    for _ in range(steps):
        opt.update([torch.randn(p.shape, generator=g) for p in leaves], state, leaves)
    return state


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_same_npz_trees(a, b):
    """Two trees as ``ckpt/io`` flattens them: the same keys, leaves equal
    bitwise with their dtypes."""
    fa, fb = io._flatten(a), io._flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _jax_state_tree(state):
    """A JAX state as ``restore_like``'s result holds it, as plain numpy trees."""
    return jio._unflatten(jio._flatten(jax.device_get(state)))


def _both_ways(tmp_path, opt, state, params, export, template, bridge):
    """The port's optax tree through JAX's reader, and JAX's save back through
    the port's, bitwise."""
    tree = to_optax(opt, state, params, export)
    io.save(str(tmp_path / "port.npz"), {"opt_state": tree})
    loaded, _ = jio.load(str(tmp_path / "port.npz"))
    restored = jio.restore_like(template, loaded["opt_state"])
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    _assert_same_npz_trees(jio._flatten(jax.device_get(restored)), io._flatten(tree))
    jio.save(str(tmp_path / "jax.npz"), {"opt_state": restored})
    back = from_optax(opt, io.load(str(tmp_path / "jax.npz"))[0]["opt_state"], params, bridge)
    _assert_same_npz_trees(to_optax(opt, back, params, export), tree)
    return back


# ---------------------------------------------------------------------------
# (a) every optimizer chain, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STAGE2))
def test_stage2_optimizer_state_reads_both_ways(tmp_path, tiny, name):
    spec, trainable = tiny
    opt = train_ss.make_optimizer(**{**OPT, **STAGE2[name]})
    state = _advance(opt, opt.init(trainable), trainable)
    export = lambda t: unbridge_second_stage(t, spec)   # noqa: E731
    jp = _jnp(export(trainable))
    template = jax.eval_shape(jtrain.make_optimizer(jp, **{**OPT, **STAGE2[name]}).init, jp)
    back = _both_ways(tmp_path, opt, state, trainable, export, template,
                      lambda t: bridge_second_stage(t, spec, CPU))
    assert [s.get("count") for s in back] == [s.get("count") for s in state]


@pytest.mark.parametrize("kind", ["direct", "flow"])
def test_student_optimizer_state_reads_both_ways(tmp_path, tiny, kind):
    """optax.adam bare (direct student) and under multi_transform with the
    integer leaves frozen (flow student): the constant lr keeps no count."""
    spec, _ = tiny
    if kind == "direct":
        student = distill.DirectStudentSpec(hidden=8, depth=1)
        params = distill.init_direct(prng.prng_key(1), spec, student, CPU)
        export, bridge = unbridge_direct, lambda t: bridge_direct(t, CPU)
        jopt = optax.adam(1e-3)
    else:
        student = distill.flow_student_spec(spec.flow, (1, 1))
        params = transformer.init(prng.prng_key(1), student, CPU)
        export, bridge = unbridge_flow, lambda t: bridge_flow(t, CPU)
        jopt = optax.multi_transform({"train": optax.adam(1e-3), "freeze": optax.set_to_zero()},
                                     jtrain._float_labels)
    opt = train_ss.adam(1e-3, masked=kind == "flow")
    state = _advance(opt, opt.init(params), params)
    jp = _jnp(export(params))
    back = _both_ways(tmp_path, opt, state, params, export, jax.eval_shape(jopt.init, jp), bridge)
    assert back[1]["count"] == back[0]["count"] == 2


def _gan_nets():
    """The stage-1 nets at the test size, numpy draws of JAX's tree shapes,
    ``u`` included (JAX layout), with their JAX specs."""
    key = jax.random.PRNGKey(0)
    fs, ds, dt = jfs.FirstStageSpec(**GAN_FS), JD.PatchDiscSpec(**GAN_DS), JD.TempDiscSpec(**GAN_DT)
    return {"gen_params": random_like(jax.eval_shape(lambda: jfs.init(key, fs)), 11),
            "ds_params": random_like(jax.eval_shape(lambda: JD.init_patch_disc(key, ds)), 12),
            "dt_params": random_like(jax.eval_shape(lambda: JD.init_temp_disc(key, dt)), 13)}


@pytest.mark.parametrize("net", ["gen_params", "ds_params"])
def test_gan_optimizer_state_reads_both_ways(tmp_path, net):
    """stage 1's chain (decay, adam(0.5, 0.9), staircase schedule) with ``u``
    masked; the temporal disc's is the same chain (its whole state:
    ``test_every_experiment_resumes_across_packages``)."""
    jnet = _gan_nets()[net]
    params = bridge_gan_params({net: jnet}, CPU)[net]
    opt = train_fs.make_gan_optimizer(2e-4, 1e-5, 0.98, 2)
    state = _advance(opt, opt.init(train_fs.trainable(params)), params, steps=3)
    export = lambda t: unbridge_gan_params({net: t})[net]   # noqa: E731
    jp = _jnp(jnet)
    template = jax.eval_shape(jtrain_fs.make_gan_optimizer(jp, 2e-4, 1e-5, 0.98, 2).init, jp)
    back = _both_ways(tmp_path, opt, state, params, export, template,
                      lambda t: bridge_gan_params({net: t}, CPU)[net])
    assert back[2]["count"] == 3


# ---------------------------------------------------------------------------
# (b) each experiment's last.npz through both packages' maybe_resume
# ---------------------------------------------------------------------------

def _jax_maybe_resume(ckpt_dir, template):
    """JAX's ``Experiment.maybe_resume`` on ``ckpt_dir``; fails on its
    'training fresh' warning."""
    warnings = []
    exp = Experiment.__new__(Experiment)
    exp.config = {"general": {"restart": True}}
    exp.ckpt_dir = str(ckpt_dir)
    exp.console = types.SimpleNamespace(info=lambda *a: None, warning=warnings.append)
    out = exp.maybe_resume(template)
    assert not warnings, warnings
    return out


def _port_maybe_resume(ckpt_dir, restore):
    fresh = object()
    out = base.maybe_resume({"general": {"restart": True}}, str(ckpt_dir), fresh, restore)
    assert out is not fresh
    return out


def _across(tmp_path, tree, template, as_jax_tree, restore, tree_of):
    """The port's ``tree`` as last.npz -> JAX's maybe_resume -> its leaves;
    JAX's save of its state -> the port's maybe_resume -> ``tree_of`` of it."""
    io.save(str(tmp_path / "port" / "last.npz"), tree, metadata={"step": 3})
    jstate = _jax_maybe_resume(tmp_path / "port", template)
    assert jax.tree_util.tree_structure(jstate) == jax.tree_util.tree_structure(template)
    jtree = as_jax_tree(jstate)
    _assert_same_npz_trees(jtree, tree)
    jio.save(str(tmp_path / "jax" / "last.npz"), jtree, metadata={"step": 3})
    back = _port_maybe_resume(tmp_path / "jax", restore)
    _assert_same_npz_trees(tree_of(back), tree)
    return back


def _stage2_state(tiny, **opt_kw):
    spec, trainable = tiny
    opt = train_ss.make_optimizer(**{**OPT, **opt_kw})
    state = train_ss.TrainState(3, trainable, _advance(opt, opt.init(trainable), trainable, 3))
    return spec, opt, state


@pytest.mark.parametrize("kind", ["second_stage", "chunked", "first_stage", "distill_direct",
                                  "distill_flow", "img_encoder", "poke_encoder"])
def test_every_experiment_resumes_across_packages(tmp_path, tiny, kind):
    as_dict = lambda s: _jax_state_tree(s._asdict())   # noqa: E731  (JAX's _ckpt_tree)
    if kind in ("second_stage", "chunked"):
        spec, opt, state = _stage2_state(tiny, **({} if kind == "chunked" else {"amsgrad": True}))
        if kind == "chunked":
            state = state._replace(params={"flow": state.params["flow"]})
            state = state._replace(opt_state=_advance(opt, opt.init(state.params), state.params, 3))
        tree = experiment.ckpt_tree(state, opt, spec)
        jp = _jnp(tree["params"])
        jopt = jtrain.make_optimizer(jp, **OPT, **({} if kind == "chunked" else {"amsgrad": True}))
        state_cls = jchunked.ChunkedTrainState if kind == "chunked" else jtrain.TrainState
        template = state_cls(jnp.zeros((), jnp.int32), jp, jax.eval_shape(jopt.init, jp))
        back = _across(tmp_path, tree, template, as_dict,
                       lambda t: experiment.restore_train_state(t, opt, state, spec, CPU),
                       lambda s: experiment.ckpt_tree(s, opt, spec))
        assert back.step == 3 and back.params.keys() == state.params.keys()
    elif kind == "first_stage":
        jnets = _gan_nets()
        nets = bridge_gan_params(jnets, CPU)
        opts = {n: train_fs.make_gan_optimizer(2e-4, 1e-5, 0.98, 2) for n in train_fs.NETS}
        state = train_fs.GanTrainState(3, *(nets[f"{n}_params"] for n in train_fs.NETS), *(
            _advance(opts[n], opts[n].init(train_fs.trainable(nets[f"{n}_params"])),
                     nets[f"{n}_params"], 1) for n in train_fs.NETS))
        tree = exp_fs.ckpt_tree(state, opts)
        jp = _jnp(jnets)
        template = jtrain_fs.GanTrainState(jnp.zeros((), jnp.int32), jp["gen_params"], jp["ds_params"],
                                           jp["dt_params"], *(
            jax.eval_shape(jtrain_fs.make_gan_optimizer(jp[f"{n}_params"], 2e-4).init,
                           jp[f"{n}_params"]) for n in train_fs.NETS))
        _across(tmp_path, tree, template, as_dict,
                lambda t: exp_fs.restore_gan_state(t, opts, state, CPU),
                lambda s: exp_fs.ckpt_tree(s, opts))
    elif kind.startswith("distill"):
        spec, _ = tiny
        config = {"distill": {"student": kind.split("_")[1], "hidden": 8, "depth": 1,
                              "num_steps": [1, 1], "lr": 1e-3}}
        student = exp_distill.student_of(config, spec)
        opt = exp_distill.make_optimizer(config, student)
        init_state, _ = distill.make_distill_step(spec, student, opt)
        state = init_state(prng.prng_key(1), CPU)
        state["step"] = 3
        _advance(opt, state["opt"], state["params"], 3)
        tree = exp_distill.ckpt_tree(state, opt, student)
        jp = _jnp(tree["params"])
        jopt = (optax.adam(1e-3) if kind == "distill_direct" else optax.multi_transform(
            {"train": optax.adam(1e-3), "freeze": optax.set_to_zero()}, jtrain._float_labels))
        template = {"params": jp, "opt": jax.eval_shape(jopt.init, jp),
                    "step": jnp.zeros((), jnp.int32)}
        _across(tmp_path, tree, template, _jax_state_tree,
                lambda t: exp_distill.restore_state(t, opt, student, state, CPU),
                lambda s: exp_distill.ckpt_tree(s, opt, student))
    else:
        from test_torch_encoders import _jax_template
        from ipoke_tpu.models import encoders as je
        from ipoke_tpu_torch.models.encoders import WrapperSpec

        if kind == "img_encoder":
            _, _, state, opts = _image_state(s=32)
            _advance(opts["gen"], state.opt_state, state.params, 1)
            _advance(opts["disc"], state.disc_opt_state, state.disc_params, 1, seed=1)
            jspec = je.WrapperSpec(nf_in=3, nf_max=16, spatial_size=32, min_spatial_size=8,
                                   deterministic=False)
            template = _jax_template("image", jspec, JD.PatchDiscSpec(ndf=8, n_layers=2))
        else:
            spec = WrapperSpec(nf_in=2, nf_max=16, spatial_size=32, min_spatial_size=8,
                               deterministic=True)
            state, opt = te.init_poke_ae(prng.prng_key(3), spec, device=CPU)
            _advance(opt, state.opt_state, state.params, 1)
            jspec = je.WrapperSpec(nf_in=2, nf_max=16, spatial_size=32, min_spatial_size=8,
                                   deterministic=True)
            template = _jax_template("poke", jspec)
        state = state._replace(step=3)
        tree = exp_enc.ckpt_tree(state)
        _across(tmp_path, tree, template, as_dict,
                lambda t: exp_enc.restore_state(t, state, CPU), exp_enc.ckpt_tree)


def test_a_tree_of_another_chain_trains_fresh_in_both(tmp_path, tiny, caplog):
    """A last.npz of torch-Adam read for an amsgrad run: JAX's restore_like
    and the port's restore both fail, and both train fresh with a warning."""
    spec, opt, state = _stage2_state(tiny)
    io.save(str(tmp_path / "last.npz"), experiment.ckpt_tree(state, opt, spec))
    _, ams, _ = _stage2_state(tiny, amsgrad=True)
    jp = _jnp(unbridge_second_stage(state.params, spec))
    template = jtrain.TrainState(jnp.zeros((), jnp.int32), jp, jax.eval_shape(
        jtrain.make_optimizer(jp, **OPT, amsgrad=True).init, jp))
    warnings = []
    exp = Experiment.__new__(Experiment)
    exp.config, exp.ckpt_dir = {"general": {"restart": True}}, str(tmp_path)
    exp.console = types.SimpleNamespace(info=lambda *a: None, warning=warnings.append)
    assert exp.maybe_resume(template) is template and "training fresh" in warnings[0]
    fresh = object()
    got = base.maybe_resume({"general": {"restart": True}}, str(tmp_path), fresh,
                            lambda t: experiment.restore_train_state(t, ams, state, spec, CPU))
    assert got is fresh and "training fresh" in caplog.text


def test_a_config_of_other_widths_raises_and_keeps_last_npz(tmp_path, monkeypatch):
    """--resume with wider MCF hidden layers than the saved run: JAX's
    maybe_resume takes no "training fresh" branch (its step then fails on
    the shapes); the port's raises before it writes, and the run's
    checkpoints stay as they were."""
    cfg = _tiny_run_config(str(tmp_path), val_every=0.5)
    dirs = {k: str(tmp_path / k) for k in ("ckpt", "log")}
    monkeypatch.setattr(experiment, "validate", lambda *a, **k: {"FVD-val": 1.0})
    first = experiment.train(cfg, dirs, device="cpu", max_steps=2)
    files = {f: (Path(first["ckpt_dir"]) / f).read_bytes()
             for f in sorted(os.listdir(first["ckpt_dir"]))}
    assert "last.npz" in files and len(files) > 1
    wide = dict(cfg, general=dict(cfg["general"], restart=True),
                architecture=dict(cfg["architecture"], flow_mid_channels_factor=4))
    spec = experiment.build_spec_from_config(wide, mcf_backend="scan")
    jp = _jnp(unbridge_second_stage(train_ss.split_params(pss.init(prng.prng_key(0), spec, CPU))[0],
                                    spec))
    template = jtrain.TrainState(jnp.zeros((), jnp.int32), jp, jax.eval_shape(
        jtrain.make_optimizer(jp, lr=1e-3, weight_decay=1e-5, warmup_steps=2, total_steps=4).init,
        jp))
    restored = _jax_maybe_resume(first["ckpt_dir"], template)
    shapes = lambda t: [np.shape(x) for x in jax.tree_util.tree_leaves(t)]   # noqa: E731
    assert shapes(restored.params) != shapes(template.params)
    with pytest.raises(ValueError):
        experiment.train(wide, dirs, device="cpu", max_steps=1)
    assert {f: (Path(first["ckpt_dir"]) / f).read_bytes()
            for f in sorted(os.listdir(first["ckpt_dir"]))} == files


# ---------------------------------------------------------------------------
# (c) metrics.jsonl on JAX's schedule; (d) checkpoint on a signal
# ---------------------------------------------------------------------------

def _scripted(i):
    return {"flow_loss": 0.5 + i / 7, "grad_norm": np.float32(3.25 * i)}


def _jax_fit_logged(log_dir, ckpt_dir, n_epochs, steps_per_epoch, val_every, log_every,
                    start=0, signal_at=None, sig=signal.SIGTERM):
    """JAX's ``Experiment.fit`` with a scripted step and validation, its
    ``RunLogger`` on ``log_dir``; step ``signal_at`` raises ``sig``.
    Returns the steps it ran."""
    exp = Experiment.__new__(Experiment)
    exp.monitor = "FVD-val"
    exp.console = types.SimpleNamespace(info=lambda *a: None, warning=lambda *a: None)
    exp.logger = JaxRunLogger(str(log_dir))
    exp.ckpt_dir = str(ckpt_dir)
    exp.ckpt_mgr = jio.CheckpointManager(exp.ckpt_dir, monitor="FVD-val", top_k=2)
    ran = []

    def step(state, batch, key):
        ran.append(state.step + 1)
        if ran[-1] == signal_at:
            signal.raise_signal(sig)
        return types.SimpleNamespace(step=state.step + 1), _scripted(ran[-1])

    step._jitted = True
    n = {"v": 0}

    def validate(state, dm):
        n["v"] += 1
        return {"FVD-val": 10.0 / n["v"], "flow_loss-val": 0.25 * n["v"]}

    dm = types.SimpleNamespace(loader=lambda split: iter(range(steps_per_epoch + 1)))
    exp._ckpt_tree = lambda state: {"step": np.int32(state.step)}
    exp.fit(step, types.SimpleNamespace(step=start), dm, jax.random.PRNGKey(0), n_epochs,
            validate=validate, val_every_steps=val_every, max_batches_per_epoch=steps_per_epoch,
            log_every=log_every)
    return ran


def _port_fit_logged(log_dir, ckpt_dir, n_epochs, steps_per_epoch, val_every, log_every,
                     start=0, signal_at=None, sig=signal.SIGTERM, max_steps=None):
    ran, n, record = [], {"v": 0}, {"preempted": None}

    def step(batch):
        ran.append(start + len(ran) + 1)
        if ran[-1] == signal_at:
            signal.raise_signal(sig)
        return _scripted(ran[-1])

    def validate(step_i):
        n["v"] += 1
        return {"FVD-val": 10.0 / n["v"], "flow_loss-val": 0.25 * n["v"]}

    end = base.fit(step, n_epochs, lambda: iter(range(steps_per_epoch + 1)), steps_per_epoch,
                   validate, val_every, max_steps=max_steps, start_step=start,
                   run_log=RunLogger(str(log_dir)), log_every=log_every,
                   save_preempted=base.preempt_saver(
                       str(ckpt_dir), lambda: {"step": np.int32(start + len(ran))}, record))
    return ran, end, record


@pytest.mark.parametrize("n_epochs,steps_per_epoch,val_every,log_every,start", [
    (2, 3, 1, 2, 0),
    (3, 4, 3, 5, 0),
    (2, 5, None, 1, 0),      # stage 1: epoch ends only
    (2, 3, 2, 2, 7),         # resumed at step 7: the counter goes on, the epochs restart
])
def test_metrics_jsonl_follows_jax(tmp_path, n_epochs, steps_per_epoch, val_every, log_every,
                                   start):
    jran = _jax_fit_logged(tmp_path / "jlog", tmp_path / "jckpt", n_epochs, steps_per_epoch,
                           val_every, log_every, start)
    ran, end, _ = _port_fit_logged(tmp_path / "plog", tmp_path / "pckpt", n_epochs,
                                   steps_per_epoch, val_every, log_every, start)
    assert ran == jran and end == start + n_epochs * steps_per_epoch
    want, got = read_metrics(str(tmp_path / "jlog")), read_metrics(str(tmp_path / "plog"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["step"] == w["step"]
        for k in w.keys() - {"step", "time"}:
            assert abs(g[k] - w[k]) <= METRICS_TOL * (1 + abs(w[k])), k
    # max_steps counts this run's steps, from the resumed counter
    ran, end, _ = _port_fit_logged(tmp_path / "cut", tmp_path / "cutc", n_epochs,
                                   steps_per_epoch, val_every, log_every, start, max_steps=2)
    assert ran == [start + 1, start + 2] and end == start + 2


def test_run_logger_media_and_a_missing_wandb_follow_jax(tmp_path, monkeypatch, caplog):
    """Without wandb both loggers warn and keep the JSONL sink; a video and an
    image land under the same names, with the same frames and pixels."""
    import cv2
    from PIL import Image

    monkeypatch.setitem(sys.modules, "wandb", None)   # its import fails
    jax_log = JaxRunLogger(str(tmp_path / "j"), use_wandb=True)
    port_log = RunLogger(str(tmp_path / "p"), use_wandb=True)
    assert jax_log.wandb is None and port_log.wandb is None
    assert "wandb unavailable" in caplog.text
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (3, 16, 24, 3)).astype(np.float32)
    image = rng.uniform(-1, 1, (16, 24, 3)).astype(np.float32)
    want = [jax_log.log_video(7, "samples", frames), jax_log.log_image(7, "poke", image)]
    got = [port_log.log_video(7, "samples", frames), port_log.log_image(7, "poke", image)]
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "samples_step7.mp4", "poke_step7.png"]

    def decoded(path):
        cap, out = cv2.VideoCapture(path), []
        while (frame := cap.read()[1]) is not None:
            out.append(frame)
        cap.release()
        return np.stack(out)

    assert np.array_equal(decoded(got[0]), decoded(want[0])) and len(decoded(got[0])) == 3
    assert np.array_equal(np.asarray(Image.open(got[1])), np.asarray(Image.open(want[1])))
    port_log.log_scalars(7, {"flow_loss": torch.tensor(0.5)}, prefix="train/")
    assert [{k: v for k, v in r.items() if k != "time"}
            for r in read_metrics(str(tmp_path / "p"))] == [{"step": 7, "train/flow_loss": 0.5}]
    logger = get_logger("ipoke_tpu_torch.test_run_logger")
    assert get_logger("ipoke_tpu_torch.test_run_logger") is logger and len(logger.handlers) == 1


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_signal_saves_after_the_step_in_flight(tmp_path, sig):
    seen = []
    sentinel = lambda signum, frame: seen.append(signum)   # noqa: E731
    old = {s: signal.signal(s, sentinel) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        k = 4
        jran = _jax_fit_logged(tmp_path / "jlog", tmp_path / "jckpt", 3, 3, 2, 50,
                               signal_at=k, sig=sig)
        ran, end, record = _port_fit_logged(tmp_path / "plog", tmp_path / "pckpt", 3, 3, 2, 50,
                                            signal_at=k, sig=sig)
        assert jran == ran == list(range(1, k + 1)) and end == k and record["preempted"] == k
        for d in ("jckpt", "pckpt"):
            tree, meta = jio.load(str(tmp_path / d / "last.npz"))
            assert meta == {"step": k, "preempted": True} and int(tree["step"]) == k
        assert not os.path.exists(tmp_path / "pckpt" / "last.npz.tmp")
        assert signal.getsignal(signal.SIGTERM) is sentinel
        assert signal.getsignal(signal.SIGINT) is sentinel and not seen
        # a normal end restores them too
        _port_fit_logged(tmp_path / "plog2", tmp_path / "pckpt2", 1, 2, None, 50)
        assert signal.getsignal(signal.SIGTERM) is sentinel and not seen
    finally:
        for s, h in old.items():
            signal.signal(s, h)


# ---------------------------------------------------------------------------
# (e) resume on the tiny second stage; (g) main --resume
# ---------------------------------------------------------------------------

def _tiny_run_config(base_dir, **training):
    cfg = tiny_config(base_dir, spatial=64, frames=3)
    cfg["general"]["experiment"] = "second_stage"
    cfg["data"].update({"dataset": "SyntheticDataset", "batch_size": 2, "n_examples": 8,
                        "n_workers": 0})
    cfg["training"] = dict({"lr": 1e-3, "lr_scaling_max_it": 2, "n_epochs": 1,
                            "max_batches_per_epoch": 4, "val_every": 10}, **training)
    return cfg


def _recorded(monkeypatch):
    """Record each step's key and batch, and each schedule read (count, lr)."""
    seen = {"keys": [], "images": [], "lr": []}
    make = train_ss.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def wrapped(state, batch, rng):
            seen["keys"].append(np.asarray(rng).tolist())
            seen["images"].append(batch["images"].clone())
            return step(state, batch, rng)
        return wrapped

    upd = train_ss._ScaleBySchedule.update

    def schedule_update(self, updates, state, params):
        seen["lr"].append((state["count"], self.schedule(state["count"])))
        return upd(self, updates, state, params)

    monkeypatch.setattr(train_ss, "make_train_step", recording)
    monkeypatch.setattr(train_ss._ScaleBySchedule, "update", schedule_update)
    monkeypatch.setattr(experiment, "validate", lambda *a, **k: {"FVD-val": 1.0})
    return seen


def test_resume_continues_the_counter_and_restarts_key_and_epoch(tmp_path, monkeypatch):
    cfg = _tiny_run_config(str(tmp_path), val_every=0.25)   # a validation record every step
    dirs = {k: str(tmp_path / k) for k in ("ckpt", "log")}
    seen = _recorded(monkeypatch)
    first = experiment.train(dict(cfg, general=dict(cfg["general"])), dirs, device="cpu",
                             max_steps=2)
    fresh = {k: list(v) for k, v in seen.items()}
    for v in seen.values():
        v.clear()
    resumed = experiment.train(dict(cfg, general=dict(cfg["general"], restart=True)), dirs,
                               device="cpu", max_steps=1)
    assert first["ckpt_dir"] == resumed["ckpt_dir"] and resumed["start_step"] == 2
    assert resumed["state"].step == 3 and resumed["resume"]["load_s"] >= 0
    assert seen["keys"] == fresh["keys"][:1]                       # the key restarts
    assert torch.equal(seen["images"][0], fresh["images"][0])      # and the epoch
    schedule = lr.second_stage_schedule(1e-3, 2, 4)
    assert seen["lr"] == [(2, schedule(2))] and schedule(2) != schedule(0)
    recs = read_metrics(dirs["log"])
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all("FVD-val" in r for r in recs)
    _, meta = io.load(resumed["ckpt"])
    assert meta == {"step": 3, "FVD-val": 1.0}


def test_main_resume_on_the_debug_config(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    argv = ["-c", str(ROOT / "configs" / "debug_second_stage.yaml"), "-m", "smoke",
            "--device", "cpu"]
    run = port_main([*argv, "--resume", "--max-steps", "1"])   # nothing to resume: fresh
    assert "no last.npz here; training fresh" in caplog.text and run["state"].step == 1
    run = port_main([*argv, "--resume", "--max-steps", "2"])
    assert run["start_step"] == 1 and run["state"].step == 3
    assert run["ckpt_dir"].endswith(os.path.join("smoke", "0"))
    _, meta = io.load(run["ckpt"])
    assert meta == {"step": 3}


# ---------------------------------------------------------------------------
# (f) training.chunked
# ---------------------------------------------------------------------------

def test_chunked_trains_flow_only_with_the_plain_optimizer(tmp_path, monkeypatch):
    cfg = _tiny_run_config(str(tmp_path), chunked=True, clip_grad_norm=1.0, amsgrad=True,
                           use_adamw=True, use_adabelief=True, min_acc_batch_size=4)
    dirs = {k: str(tmp_path / k) for k in ("ckpt", "log")}
    built = []
    make = train_ss.make_train_step
    monkeypatch.setattr(train_ss, "make_train_step",
                        lambda *a, **k: built.append((a, k)) or make(*a, **k))
    monkeypatch.setattr(experiment, "validate", lambda *a, **k: {"FVD-val": 1.0})
    run = experiment.train(cfg, dirs, device="cpu", max_steps=1)
    (spec, frozen, opt), kw = built[0]
    assert list(run["state"].params) == ["flow"] and "flow" not in frozen
    assert [t.name for t in opt.transforms] == ["decayed_weights", "adam", "schedule"]
    assert kw["n_microbatches"] == 1
    assert sorted(run["history"][0]) == ["flow_loss", "nll_loss", "nlogdet_loss", "step_s"]
    tree, _ = jio.load(run["ckpt"])
    jp = _jnp(tree["params"])
    template = jchunked.ChunkedTrainState(
        jnp.zeros((), jnp.int32), jp, jax.eval_shape(jtrain.make_optimizer(jp, **OPT).init, jp))
    restored = jio.restore_like(template, tree)
    assert int(restored.step) == 1 and list(restored.params) == ["flow"]


@pytest.mark.slow
def test_chunked_step_matches_jax_make_chunked_trainer(tiny):
    """One port step of the chunked branch (``make_train_step`` with only the
    flow trainable) against JAX's per-level ``make_chunked_trainer`` on the
    same params and batch: the loss, and the updated flow leaves, within
    2e-4·(1+max|ref|)."""
    from test_torch_density import density_model

    tol = 2e-4
    pt, spec, pj, jspec, batch = density_model(seed=3)
    kw = dict(lr=1e-3, weight_decay=1e-5, warmup_steps=0, total_steps=10)
    # JAX first: its CPU arrays may share memory with the port's tensors,
    # which the port's step updates in place
    jtrainable, jfrozen = jtrain.split_params(pj)
    chunk = {"flow": jtrainable["flow"]}
    jopt = jtrain.make_optimizer(chunk, **kw)
    jstate = jchunked.ChunkedTrainState(jnp.zeros((), jnp.int32), chunk, jopt.init(chunk))
    jstep = jchunked.make_chunked_trainer(jspec.flow, jspec, jfrozen, jopt)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jflow = {k: np.array(v) for k, v in flatten(jax.device_get(jstate.params["flow"])).items()}
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    trainable, frozen = train_ss.split_params(pt)
    frozen.update({k: v for k, v in trainable.items() if k != "flow"})
    opt = train_ss.make_optimizer(**kw)
    state = train_ss.init_state({"flow": trainable["flow"]}, opt)
    step = train_ss.make_train_step(spec, frozen, opt)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                          prng.prng_key(5))
    for k in ("flow_loss", "nll_loss", "nlogdet_loss"):
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= tol * (1 + abs(want)), k
    got = flatten(unbridge_flow(state.params["flow"]))
    for k, w in jflow.items():
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(got[k] - w).max() <= tol * (1 + np.abs(w).max()), k
        else:
            assert np.array_equal(got[k], w), k
