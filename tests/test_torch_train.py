"""The port's stage-2 training against the JAX package on the CPU.

* Gradients: the port's ``make_train_step`` (autograd) against JAX's
  ``make_train_step`` (``jax.value_and_grad`` of its ``loss_fn``) on the same
  params, batch and key, per flow leaf within 2e-4·(1+max|g_ref|), with the
  step's metrics; both steps run with an optimizer that keeps the gradients
  it is given, so the gradients are read exactly.  Two microbatches give the
  mean of the gradients of the halves under ``split(key, 2)``, as JAX's scan
  does.  bf16 ``compute_dtype``: the loss within twice JAX's own bf16-vs-f32
  loss gap on this model, the gradients within twice JAX's gradient gap
  (``JAX_BF16_GRAD_GAP``).
* Optimizers: three steps of every optimizer of ``make_optimizer`` on the
  same gradients, params within 1e-6; integer leaves untouched.
* The lr schedule, checkpoints in JAX's npz layout both ways (bitwise), and
  the trainer of ``experiments/second_stage`` on the debug config.

The model is tests/test_torch_density.py's; the JAX references come from one
jitted function for the step (~30 s to compile here) and one for the
optimizers."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.flows.loss import flow_loss
from ipoke_tpu.models import second_stage as jss
from ipoke_tpu.nn.core import Policy
from ipoke_tpu.train import lr as jlr
from ipoke_tpu.train import second_stage as jtrain
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_flow, bridge_second_stage, unbridge_second_stage
from ipoke_tpu_torch.ckpt.optax_layout import masked_like
from ipoke_tpu_torch.config import load_parameters
from ipoke_tpu_torch.experiments import second_stage as experiment
from ipoke_tpu_torch.train import lr
from ipoke_tpu_torch.train import second_stage as train
from ipoke_tpu_torch.utils import prng
from test_torch_density import density_model
from torch_port_util import CPU, clone_tree, flatten, jit_o0, np_tree

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 2e-4     # the slice's f32 tolerance, per leaf relative to 1 + max|g_ref|
PARAM_TOL = 1e-6
STEP_KEY = 21
OPT_KW = dict(lr=1e-3, weight_decay=1e-2, warmup_steps=2, total_steps=10)
N_OPT_STEPS = 3      # lr(0) = 0, so the later steps move the params
OPTIMIZERS = {
    "torch_adam": {},
    "torch_adam_amsgrad": {"amsgrad": True},
    "adamw": {"use_adamw": True},
    "adabelief": {"use_adabelief": True},
    "clip": {"clip_grad_norm": 1.0},          # the gradients' norm is far above 1
}
# JAX's own bf16 gradients on this model lie up to 0.177 from its f32 ones
# (max over the flow's leaves of max|g_bf16 - g_f32| / (1 + max|g_f32|);
# the port's lie 0.135 away); a JAX bf16 step would double the compile.
JAX_BF16_GRAD_GAP = 0.177


def _jax_capture():
    """An optax transformation whose state becomes the gradients it is given."""
    def update(g, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, g), g

    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), update)


class _Capture:
    """The port's counterpart: keeps the gradients, updates nothing."""
    name = "capture"

    def init(self, params):
        return {}

    def update(self, updates, state, params):
        state["grads"] = [u.clone() for u in updates]
        return [torch.zeros_like(u) for u in updates]


@pytest.fixture(scope="module")
def model():
    pt, spec, pj, jspec, batch = density_model(seed=2)
    jtrain_p, jfrozen = jtrain.split_params(pj)

    @jit_o0
    def reference(trainable, b):
        step = jtrain.make_train_step(jspec, jfrozen, _jax_capture())
        state, metrics = step(jtrain.init_state(trainable, _jax_capture()), b,
                              jax.random.PRNGKey(STEP_KEY))
        bf16 = Policy(jnp.bfloat16)
        out, logdet, _ = jss.forward_density(bf16.cast({**jfrozen, **trainable}), jspec, bf16.cast(b))
        return state.opt_state, metrics, flow_loss(out, logdet)[0]

    ref = reference(jtrain_p, {k: jnp.asarray(v) for k, v in batch.items()})
    return pt, spec, batch, ref


def _port_grads(pt, spec, batch, n=1, dtype=None, key=prng.prng_key(STEP_KEY)):
    trainable, frozen = train.split_params(pt)
    trainable = clone_tree(trainable)
    opt = train.Optimizer([_Capture()])
    state = train.init_state(trainable, opt)
    step = train.make_train_step(spec, frozen, opt, n_microbatches=n, compute_dtype=dtype)
    _, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, key)
    return masked_like(trainable, state.opt_state[0]["grads"], lambda: None), metrics


def _grad_errors(got, want):
    """Per float leaf: max |got - want| / (1 + max |want|)."""
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    return {k: float((g - want[k]).abs().max() / (1 + want[k].abs().max()))
            for k, g in got.items() if g is not None}


def test_gradients_match_jax(model):
    pt, spec, batch, ref = model
    grads, metrics = _port_grads(pt, spec, batch)
    errs = _grad_errors(grads, bridge_second_stage(np_tree(ref[0]), spec, device=CPU))
    assert len(errs) > 100 and max(errs.values()) <= GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])
    r_metrics = ref[1]
    assert metrics.keys() == r_metrics.keys()
    for k, v in r_metrics.items():
        v = float(v)
        assert abs(float(metrics[k]) - v) <= GRAD_TOL * (1 + abs(v)), (k, float(metrics[k]), v)
    assert float(metrics["grad_norm"]) > 0.1


def test_two_microbatches_average_the_halves(model):
    pt, spec, batch, _ = model
    grads, metrics = _port_grads(pt, spec, batch, n=2)
    keys = prng.split(prng.prng_key(STEP_KEY), 2)
    halves = [_port_grads(pt, spec, {k: v[i:i + 1] for k, v in batch.items()}, key=keys[i])
              for i in range(2)]
    mean = masked_like(train.split_params(pt)[0], [(a + b) / 2 for a, b in zip(
        train.float_leaves(halves[0][0]), train.float_leaves(halves[1][0]))], lambda: None)
    assert max(_grad_errors(grads, mean).values()) <= 1e-6
    for k, v in halves[1][1].items():   # the logs of the last microbatch
        if k != "grad_norm":
            assert float(metrics[k]) == float(v), k
    assert float(metrics["grad_norm"]) == float(train.global_norm(train.float_leaves(grads)))


def test_bf16_within_jax_own_gap(model):
    """bf16 rounds at other places in the two frameworks (JAX rounds each
    step of its norms), so the port's bf16 step is held to JAX's f32 one
    within twice JAX's own bf16 gap."""
    pt, spec, batch, ref = model
    grads, metrics = _port_grads(pt, spec, batch, dtype=torch.bfloat16)
    f32 = bridge_second_stage(np_tree(ref[0]), spec, device=CPU)
    assert all(g.dtype == torch.float32 for g in train.float_leaves(grads))
    port_gap = max(_grad_errors(grads, f32).values())
    assert 0 < port_gap <= 2 * JAX_BF16_GRAD_GAP, port_gap
    loss_f32 = float(ref[1]["flow_loss"])
    jax_loss_gap = abs(float(ref[2]) - loss_f32)
    assert 0 < abs(float(metrics["flow_loss"]) - loss_f32) <= 2 * jax_loss_gap


@pytest.fixture(scope="module")
def optimizer_runs():
    """Params after N_OPT_STEPS of each optimizer on the same gradients, on a
    tree of the flow's kinds of leaves (a conv kernel, weight-norm vectors,
    a permutation): {name: (JAX's, the port's, the port's start)}."""
    rng = np.random.default_rng(5)
    params = {"levels": [{"w": rng.standard_normal((3, 3, 4, 8)), "g": rng.uniform(0.5, 1, 8),
                          "bias": np.zeros(6), "fwd_idx": rng.permutation(6)},
                         {"log_scale": 0.05 * rng.standard_normal(5)}]}
    params = jax.tree_util.tree_map(
        lambda a: a.astype(np.int32 if a.dtype.kind == "i" else np.float32), params)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * rng.uniform(0.01, 3)).astype(np.float32)
        if a.dtype == np.float32 else np.zeros_like(a), params)

    @jax.jit
    def reference(params, grads):
        out = {}
        for name, kw in OPTIMIZERS.items():
            opt = jtrain.make_optimizer(params, **OPT_KW, **kw)
            p, s = params, opt.init(params)
            for _ in range(N_OPT_STEPS):
                u, s = opt.update(grads, s, p)
                p = optax.apply_updates(p, u)
            out[name] = p
        return out

    ref = reference(params, grads)
    to_torch = lambda tree: jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)  # noqa: E731
    runs = {}
    for name, kw in OPTIMIZERS.items():
        p_tree, start = to_torch(params), to_torch(params)
        opt = train.make_optimizer(**OPT_KW, **kw)
        p, state = train.float_leaves(p_tree), opt.init(p_tree)
        g = train.float_leaves(to_torch(grads))
        with torch.no_grad():
            for _ in range(N_OPT_STEPS):
                torch._foreach_add_(p, opt.update([x.clone() for x in g], state, p))
        runs[name] = (to_torch(ref[name]), p_tree, start)
    return runs


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_make_optimizer(optimizer_runs, name):
    want, got, start = (flatten(t) for t in optimizer_runs[name])
    assert got.keys() == want.keys()
    for k, w in want.items():
        if not w.is_floating_point():      # the permutation: no update
            assert torch.equal(got[k], start[k]) and torch.equal(w, start[k].to(w.dtype)), k
            continue
        err = float((got[k] - w).abs().max())
        assert err <= PARAM_TOL, (k, err)
        assert not torch.equal(got[k], start[k]), k


@pytest.mark.parametrize("warmup,total", [(500, 200_000), (2, 10), (0, 7)])
def test_lr_schedule_matches_jax(warmup, total):
    ours = lr.second_stage_schedule(1e-3, warmup, total)
    theirs = jlr.second_stage_schedule(1e-3, warmup, total)
    for step in sorted({0, 1, warmup // 2, warmup, (warmup + total) // 2, total - 1, total, total + 5}):
        assert ours(step) == float(theirs(jnp.asarray(step))), step
    assert ours(0) == 0.0 or warmup == 0


def test_train_step_moves_floats_and_leaves_integers(model):
    pt, spec, batch, _ = model
    trainable, frozen = train.split_params(pt)
    trainable = clone_tree(trainable)
    start = flatten(clone_tree(trainable))
    frozen_start = flatten(clone_tree(frozen))
    opt = train.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=10)
    state = train.init_state(trainable, opt)
    step = train.make_train_step(spec, frozen, opt)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        state, metrics = step(state, b, prng.prng_key(i))
        assert np.isfinite(float(metrics["flow_loss"]))
    assert state.step == 2 and state.opt_state[-1]["count"] == 2
    after = flatten(state.params)
    assert all(torch.equal(after[k], v) for k, v in start.items() if not v.is_floating_point())
    assert sum(not torch.equal(after[k], v) for k, v in start.items() if v.is_floating_point()) > 100
    frozen_after = flatten(frozen)
    assert all(torch.equal(frozen_after[k], v) for k, v in frozen_start.items())
    assert all(not v.requires_grad for v in frozen_after.values())


def test_checkpoint_round_trips_with_jax(model, tmp_path):
    """port -> ckpt/io.save -> JAX ckpt/io.load is bitwise on the params, and
    JAX save -> port load -> port save -> JAX load too."""
    pt, spec, _, _ = model
    tree = unbridge_second_stage(pt, spec)
    path = str(tmp_path / "port.npz")
    io.save(path, {"step": np.int32(3), "params": tree, "opt_state": {"count": 3, "none": None}},
            metadata={"step": 3})
    loaded, meta = jio.load(path)
    assert meta == {"step": 3} and int(loaded["step"]) == 3 and loaded["opt_state"]["none"] is None
    want, got = flatten(tree), flatten(np_tree(loaded["params"]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert got["flow/levels/0/steps/conv1x1/fwd_idx"].dtype == np.int32
    assert got["flow/levels/0/steps/conv1x1/fwd_idx"].shape == (1, 16)   # steps stacked

    jpath, back = str(tmp_path / "jax.npz"), str(tmp_path / "back.npz")
    jio.save(jpath, {"params": loaded["params"]})
    port_tree, _ = io.load(jpath)
    params = bridge_second_stage(port_tree["params"], spec, device=CPU)
    start = flatten(pt)
    for k, v in flatten(params).items():
        assert torch.equal(v, start[k]), k
    io.save(back, {"params": unbridge_second_stage(params, spec)})
    again, _ = jio.load(back)
    for k, w in flatten(np_tree(again["params"])).items():
        assert np.array_equal(w, want[k]) and w.dtype == want[k].dtype, k


def test_checkpoint_manager_keeps_the_best(tmp_path):
    mgr = io.CheckpointManager(str(tmp_path), monitor="FVD-val", top_k=2)
    for step, fvd in ((1, 30.5), (2, 12.25), (3, 20.0)):
        mgr.save_step({"step": np.int32(step)}, step, fvd)
    assert sorted(mgr.best_k.values()) == [12.25, 20.0]
    assert not (tmp_path / "step=1-FVD-val=30.500.npz").exists()
    assert io.find_best(str(tmp_path)) == str(tmp_path / "step=2-FVD-val=12.250.npz")
    last, meta = jio.load(str(tmp_path / "last.npz"))
    assert int(last["step"]) == 3 and meta == {"step": 3, "FVD-val": 20.0}


def test_trainer_on_the_debug_config(tmp_path):
    """``experiments/second_stage.train`` on configs/debug_second_stage.yaml,
    2 steps on the CPU: finite losses, last.npz in JAX's layout."""
    cfg, dirs = load_parameters(str(ROOT / "configs" / "debug_second_stage.yaml"), "smoke",
                                base_dir=str(tmp_path))
    run = experiment.train(cfg, dirs, device="cpu", max_steps=2)
    assert run["state"].step == 2 and len(run["history"]) == 2
    assert all(np.isfinite(h["flow_loss"]) and np.isfinite(h["grad_norm"]) for h in run["history"])
    tree, meta = jio.load(run["ckpt"])
    assert meta == {"step": 2} and int(tree["step"]) == 2
    assert sorted(tree["params"]) == ["flow"]
    chain = tree["opt_state"]["inner_states"]["train"]["inner_state"]   # optax's layout
    assert int(chain[1]["count"]) == 2 and int(chain[2]["count"]) == 2
    saved = bridge_second_stage(np_tree(tree["params"]), run["spec"], device=CPU)
    trained = flatten(run["state"].params)
    for k, v in flatten(saved).items():
        assert torch.equal(v, trained[k]), k
    if not torch.cuda.is_available():   # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            experiment.train(cfg, dirs, max_steps=1)
