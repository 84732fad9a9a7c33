"""The port's distillation (``train/distill.py``, ``experiments/distill.py``)
against the JAX package on the CPU.

The teacher is tests/test_serve_artifact.py's tiny second stage (two flow
levels of one step, 64x64, 4 frames; test_distill.py's two steps per level
would double the JAX compiles), drawn by the port's ``init`` (JAX's
numbers) with the flow's output gains set non-zero and carried to JAX's
layout by ``ckpt/jax_bridge``; the students are tests/test_distill.py's
direct student (hidden 32, depth 2) and a flow student of one step per
level.  The teacher's MCF
inverses run on the default backend ``'cuda_unit'``, whose custom op takes
K2's plain version on CPU tensors.  Every JAX reference with a gradient
comes from one jitted function per student kind, compiled at XLA's backend
optimisation level 0 (``torch_port_util.jit_o0``).

* ``init_direct`` within 1e-6·(1+|ref|); ``direct_apply`` on the trained
  student of ``artifacts/student_direct.npz`` at its full width within
  1e-4·(1+max|ref|); the npz round-trips bitwise.
* ``direct_loss`` (and ``teacher_finite_frac``) on a batch with every
  teacher example finite, one non-finite, and none finite (NaN), with the
  gradients within 2e-4·(1+max|g|) per leaf; ``flow_student_loss`` and its
  gradients, the same.
* Three ``make_distill_step`` steps of optax's adam per student kind within
  1e-5·(1+|ref|) per element.
* ``forward_sample_student`` with a fixed z and on JAX keys (n_samples 1 and
  2) within 2e-4 (the slice's f32 tolerance).
* The distill CLI on configs/debug_distill.yaml: train, checkpoints in JAX's
  npz layout read by JAX's ``ckpt/io``, and test.
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.train import distill as jdistill
from ipoke_tpu.train import second_stage as jtrain
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import (
    bridge_direct, bridge_flow, unbridge_direct, unbridge_flow, unbridge_second_stage)
from ipoke_tpu_torch.ckpt.optax_layout import masked_like
from ipoke_tpu_torch.experiments import distill as experiment
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.train import distill
from ipoke_tpu_torch.train.second_stage import adam, float_leaves
from ipoke_tpu_torch.utils import prng, synth
from test_serve_artifact import _spec as jax_teacher_spec
from torch_port_util import (CPU, clone_tree, flatten, jit_o0, np_tree, port_second_stage_spec,
                             t)

ROOT = Path(__file__).resolve().parents[1]
STUDENT_NPZ = ROOT / "artifacts" / "student_direct.npz"
INIT_TOL = 1e-6
APPLY_TOL = 1e-4     # 8 convs of width 256 deep, relative to 1 + max|ref|
GRAD_TOL = 2e-4      # the training slice's per-leaf tolerance
STEP_TOL = 1e-5
SAMPLE_TOL = 2e-4
LR = 1e-3
N_STEPS = 3
B = 2
CASES = ("finite", "one_nonfinite", "none_finite")
SP_KEYS = {"direct": 7, "flow": 8}    # the students' init keys
SAMPLE_SEED = 2**32 - 5


def _zs(rng, spec):
    """(N_STEPS, B, 8, 8, C) draws; as the three loss cases, the teacher's
    motion is finite on draw 0, non-finite on example 0 of draw 1 and on
    both examples of draw 2.  One entry of 1e5 makes the teacher's reverse
    overflow in its example (every op of the reverse is per example), while
    the student's output stays finite, as when a trained teacher blows up
    on a rare draw."""
    z = rng.standard_normal((N_STEPS, B, spec.latent_size, spec.latent_size,
                             spec.flow_in_channels)).astype(np.float32)
    z[1, 0, 2, 5, 3] = 1e5
    z[2, :, 4, 4, 0] = 1e5
    return z


@pytest.fixture(scope="module")
def teacher():
    jspec = jax_teacher_spec()
    spec = port_second_stage_spec(jspec, mcf_backend="cuda_unit")
    pt = second_stage.init(prng.prng_key(3), spec, device=CPU)
    pt["flow"] = synth.set_flow_output_gains(pt["flow"], 0.05)
    pj = jax.tree_util.tree_map(jnp.asarray, unbridge_second_stage(pt, spec))
    rng = np.random.default_rng(4)
    batch = {"images": rng.uniform(-1, 1, (B, 4, 64, 64, 3)).astype(np.float32),
             "poke": rng.standard_normal((B, 64, 64, 2)).astype(np.float32)}
    cond = second_stage.embed_cond(pt, spec, t(batch["images"][:, 0]), t(batch["poke"]))
    return {"spec": spec, "jspec": jspec, "pt": pt, "pj": pj, "batch": batch, "cond": cond,
            "zs": _zs(rng, spec)}


def _jax_runs(kind, tch, student_j, sp_j):
    """JAX's losses and gradients on each draw of ``zs`` (vmapped) for the
    direct student, on the first draw for the flow student (its integer
    shuffle leaves get zeros, as in ``make_distill_step``), and N_STEPS
    steps of ``make_distill_step`` with ``optax.adam(LR)`` from ``sp_j`` on
    the first draw; one jit."""
    jspec, cond = tch["jspec"], jnp.asarray(tch["cond"].numpy())
    loss_fn = jdistill.direct_loss if kind == "direct" else jdistill.flow_student_loss

    @jit_o0
    def run(sp, tp, zs):
        out = {}
        if kind == "direct":
            out["cases"] = jax.vmap(lambda z: jax.value_and_grad(loss_fn, has_aux=True)(
                sp, student_j, tp, jspec, z, cond))(zs)
        else:
            (loss, logs), grads = jax.value_and_grad(loss_fn, has_aux=True, allow_int=True)(
                sp, student_j, tp, jspec, zs[0], cond)
            out["grad"] = (loss, jtrain.sanitize_int_grads(grads, sp))
        init_state, step = jdistill.make_distill_step(jspec, student_j, optax.adam(LR))
        opt = optax.adam(LR) if kind == "direct" else optax.multi_transform(
            {"train": optax.adam(LR), "freeze": optax.set_to_zero()}, jtrain._float_labels)
        state = {"params": sp, "opt": opt.init(sp), "step": jnp.zeros((), jnp.int32)}
        state, logs = jax.lax.scan(lambda s, z: step(s, tp, z, cond), state,
                                   zs[:1].repeat(N_STEPS, 0))
        out["state"], out["logs"] = state, logs
        return out

    return run(sp_j, tch["pj"], jnp.asarray(tch["zs"]))


@pytest.fixture(scope="module")
def direct(teacher):
    ds = distill.DirectStudentSpec(hidden=32, depth=2)
    sp = distill.init_direct(prng.prng_key(SP_KEYS["direct"]), teacher["spec"], ds, CPU)
    ref = _jax_runs("direct", teacher, jdistill.DirectStudentSpec(hidden=32, depth=2),
                    jax.tree_util.tree_map(jnp.asarray, unbridge_direct(sp)))
    return ds, sp, ref


@pytest.fixture(scope="module")
def flow_student(teacher):
    s_spec = distill.flow_student_spec(teacher["spec"].flow, (1, 1))
    sp = synth.set_flow_output_gains(
        transformer.init(prng.prng_key(SP_KEYS["flow"]), s_spec, CPU), 0.05)
    js_spec = jdistill.flow_student_spec(teacher["jspec"].flow, (1, 1))
    ref = _jax_runs("flow", teacher, js_spec,
                    jax.tree_util.tree_map(jnp.asarray, unbridge_flow(sp)))
    return s_spec, sp, ref


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / (1 + np.abs(ref).max()))


def test_flow_student_spec_keeps_the_level_count(teacher):
    flow = teacher["spec"].flow
    assert distill.flow_student_spec(flow, (1, 1)).num_steps == (1, 1)
    with pytest.raises(ValueError, match="level count"):
        distill.flow_student_spec(flow, (1,))


def test_init_direct_matches_jax(teacher):
    ds = distill.DirectStudentSpec(hidden=32, depth=2)
    ref = bridge_direct(np_tree(jdistill.init_direct(
        jax.random.PRNGKey(7), teacher["jspec"], jdistill.DirectStudentSpec(hidden=32, depth=2))), CPU)
    got, want = flatten(distill.init_direct(prng.prng_key(7), teacher["spec"], ds, CPU)), flatten(ref)
    assert got.keys() == want.keys() and len(got) == 4 + 2 * 2 * 4
    for k, v in want.items():
        tol = INIT_TOL * (1 + v.abs())
        assert got[k].shape == v.shape and bool(((got[k] - v).abs() <= tol).all()), k


def test_direct_apply_matches_jax_on_the_trained_student():
    tree, meta = jio.load(str(STUDENT_NPZ))
    assert meta["kind"] == "direct" and (meta["hidden"], meta["depth"]) == (256, 6)
    ds = distill.DirectStudentSpec(hidden=256, depth=6)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((B, 8, 8, 32)).astype(np.float32)
    cond = rng.standard_normal((B, 8, 8, 128)).astype(np.float32)
    ref = np.asarray(jdistill.direct_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                           jdistill.DirectStudentSpec(hidden=256, depth=6),
                                           jnp.asarray(z), jnp.asarray(cond)))
    out = distill.direct_apply(bridge_direct(STUDENT_NPZ, CPU), ds, t(z), t(cond)).detach().numpy()
    assert out.shape == (B, 8, 8, 32) and np.abs(ref).max() > 0.1
    assert _rel_err(out, ref) <= APPLY_TOL


def test_student_npz_round_trips_bitwise(tmp_path):
    path = str(tmp_path / "student.npz")
    params = bridge_direct(str(STUDENT_NPZ), CPU)
    assert tuple(params["conv_in"]["conv"]["w"].shape) == (256, 160, 3, 3)   # OIHW
    io.save(path, unbridge_direct(params), metadata={"kind": "direct"})
    with np.load(STUDENT_NPZ) as a, np.load(path) as b:
        keys = set(a.files) - {"__metadata__"}
        assert keys == set(b.files) - {"__metadata__"} and "res::__len__" in keys
        for k in keys:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _port_loss_and_grads(kind, tch, student, sp, z):
    sp = clone_tree(sp)
    for p in float_leaves(sp):
        p.requires_grad_(True)
    loss_fn = distill.direct_loss if kind == "direct" else distill.flow_student_loss
    loss, logs = loss_fn(sp, student, tch["pt"], tch["spec"], t(z), tch["cond"])
    p = float_leaves(sp)
    grads = torch.autograd.grad(loss, p, allow_unused=True)
    return loss.detach(), logs, [torch.zeros_like(x) if g is None else g for x, g in zip(p, grads)]


@pytest.mark.parametrize("case", CASES)
def test_direct_loss_and_gradients_match_jax(teacher, direct, case):
    ds, sp, ref = direct
    i = CASES.index(case)
    loss, logs, grads = _port_loss_and_grads("direct", teacher, ds, sp, teacher["zs"][i])
    (r_loss, r_logs), r_grads = jax.tree_util.tree_map(lambda a: np.asarray(a[i]), ref["cases"])
    frac = {"finite": 1.0, "one_nonfinite": 0.5, "none_finite": 0.0}[case]
    assert float(logs["teacher_finite_frac"]) == float(r_logs["teacher_finite_frac"]) == frac
    if case == "none_finite":   # surfaces as NaN, not as a zero loss
        assert np.isnan(float(loss)) and np.isnan(r_loss)
        assert np.isnan(float(logs["distill_mse"].detach()))
    else:
        assert abs(float(loss) - float(r_loss)) <= 1e-5 * (1 + abs(float(r_loss)))
        assert float(logs["distill_mse"].detach()) == float(loss)
    r_grads = flatten(bridge_direct(r_grads, CPU))
    got = flatten(masked_like(sp, grads, lambda: None))
    assert got.keys() == r_grads.keys()
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
        assert _rel_err(g.numpy(), r_grads[k].numpy()) <= GRAD_TOL, k
    if case != "none_finite":
        assert max(float(g.abs().max()) for g in grads) > 1e-3


def test_flow_student_loss_matches_jax(teacher, flow_student):
    s_spec, sp, ref = flow_student
    loss, logs, grads = _port_loss_and_grads("flow", teacher, s_spec, sp, teacher["zs"][0])
    r_logs = jax.tree_util.tree_map(lambda a: float(a[0]), ref["logs"])
    for k in ("flow_loss", "nll_loss", "nlogdet_loss"):
        assert abs(float(logs[k].detach()) - r_logs[k]) <= 1e-5 * (1 + abs(r_logs[k])), k
    assert float(loss) == float(logs["flow_loss"].detach())
    r_loss, r_grads = ref["grad"]
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * (1 + abs(float(r_loss)))
    r_grads = flatten(bridge_flow(np_tree(r_grads), CPU))
    got = {k: g for k, g in flatten(masked_like(sp, grads, lambda: None)).items() if g is not None}
    assert got and got.keys() <= r_grads.keys()
    assert all(not r_grads[k].is_floating_point() for k in r_grads.keys() - got.keys())
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
        assert _rel_err(g.numpy(), r_grads[k].numpy()) <= GRAD_TOL, k
    assert max(float(g.abs().max()) for g in grads) > 1e-3


def _port_steps(kind, tch, student, sp):
    init_state, step = distill.make_distill_step(tch["spec"], student, adam(LR))
    # the key ``sp`` was drawn from; its float leaves (the flow student's
    # output gains) are then set to ``sp``'s
    state = init_state(prng.prng_key(SP_KEYS[kind]), CPU)
    with torch.no_grad():
        for a, b in zip(float_leaves(state["params"]), float_leaves(sp)):
            a.copy_(b)
    start = clone_tree(state["params"])
    logs = []
    for _ in range(N_STEPS):
        state, lg = step(state, tch["pt"], t(tch["zs"][0]), tch["cond"])
        logs.append(lg)
    return state, logs, start


@pytest.mark.parametrize("kind", ["direct", "flow"])
def test_distill_steps_match_jax(teacher, direct, flow_student, kind):
    student, sp, ref = direct if kind == "direct" else flow_student
    state, logs, start = _port_steps(kind, teacher, student, sp)
    assert state["step"] == N_STEPS == int(ref["state"]["step"])
    if kind == "direct":
        want = bridge_direct(np_tree(ref["state"]["params"]), CPU)
    else:
        want = bridge_flow(np_tree(ref["state"]["params"]), CPU)
    got, want, start = flatten(state["params"]), flatten(want), flatten(start)
    assert got.keys() == want.keys()
    moved = 0
    for k, v in got.items():
        if not v.is_floating_point():   # shuffle permutations: frozen
            assert torch.equal(v, start[k]) and torch.equal(v, want[k]), k
            continue
        moved += not torch.equal(v.detach(), start[k])
        tol = STEP_TOL * (1 + want[k].abs())
        assert bool(((v.detach() - want[k]).abs() <= tol).all()), (k, float((v - want[k]).abs().max()))
    assert moved > len(got) // 2
    r_loss = np.asarray(ref["logs"]["loss"])
    for i, lg in enumerate(logs):
        assert abs(float(lg["loss"]) - r_loss[i]) <= 1e-5 * (1 + abs(r_loss[i])), i


@pytest.fixture(scope="module")
def student_samples(teacher, direct):
    """JAX's ``forward_sample_student`` of the direct student with a fixed z
    and on a JAX key (n_samples 1 and 2); one jit."""
    _, sp, _ = direct
    js = jdistill.DirectStudentSpec(hidden=32, depth=2)

    @jit_o0
    def run(p, sp_j, batch, z, key):
        sample = lambda **kw: jdistill.forward_sample_student(  # noqa: E731
            p, sp_j, js, teacher["jspec"], batch, **kw)
        return {"fixed_z": sample(rng=None, add_first_frame=True, z=z),
                "rng_1": sample(rng=key, n_samples=1), "rng_2": sample(rng=key, n_samples=2)}

    return run(teacher["pj"], jax.tree_util.tree_map(jnp.asarray, unbridge_direct(sp)),
               {k: jnp.asarray(v) for k, v in teacher["batch"].items()},
               jnp.asarray(teacher["zs"][0]), jax.random.PRNGKey(np.uint32(SAMPLE_SEED)))


@pytest.mark.parametrize("draw", ["fixed_z", "rng_1", "rng_2"])
def test_forward_sample_student_matches_jax(teacher, direct, student_samples, draw):
    ds, sp, _ = direct
    tb = {k: t(v) for k, v in teacher["batch"].items()}
    if draw == "fixed_z":
        out = distill.forward_sample_student(teacher["pt"], sp, ds, teacher["spec"], tb,
                                             add_first_frame=True, z=t(teacher["zs"][0]))
        shape = (1, B, 4, 64, 64, 3)
    else:
        n = int(draw[-1])
        out = distill.forward_sample_student(teacher["pt"], sp, ds, teacher["spec"], tb,
                                             rng=prng.prng_key(SAMPLE_SEED), n_samples=n)
        shape = (n, B, 3, 64, 64, 3)
    out, ref = out.numpy(), np.asarray(student_samples[draw])
    assert out.shape == ref.shape == shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_distill_cli_trains_and_tests(tmp_path, monkeypatch, caplog):
    """The debug config, its one epoch of four steps: a fresh teacher (with
    the warning), the epoch's end validated into a top-k checkpoint and
    last.npz that JAX's ckpt/io reads in its layout (optax's state
    included), then teacher and student videos."""
    monkeypatch.chdir(tmp_path)
    argv = ["-c", str(ROOT / "configs" / "debug_distill.yaml"), "-m", "t", "--device", "cpu"]
    experiment.main(["train", *argv])
    assert "FRESH teacher" in caplog.text
    ckpt = tmp_path / "logs" / "distill" / "ckpt" / "t" / "0"
    best = io.find_best(str(ckpt))
    assert best and Path(best).name.startswith("step=4-distill-val=")
    tree, meta = jio.load(str(ckpt / "last.npz"))
    assert meta["step"] == 4 and int(tree["step"]) == 4
    assert tree["params"]["conv_in"]["conv"]["w"].shape == (3, 3, 16 + 32, 32)   # HWIO
    assert len(tree["params"]["res"]) == 2
    assert tree["opt"][0]["count"] == 4 and tree["opt"][1] == {}   # optax.adam: (adam, scale)
    assert tree["opt"][0]["mu"]["conv_out"]["conv"]["w"].shape == (3, 3, 32, 16)
    experiment.main(["test", *argv])
    out = tmp_path / "logs" / "distill" / "generated" / "t" / "distill_samples"
    names = sorted(os.listdir(out))
    assert [n.split(".")[0] for n in names] == ["ex0_student", "ex0_teacher", "ex1_student",
                                                "ex1_teacher"]
