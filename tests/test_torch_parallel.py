"""The port's parallel slice (``ipoke_tpu_torch/parallel``, ``train/second_stage.
shard_train_setup``, ``forward_sample(mesh=)``, ``device_prefetch(mesh=)``)
against the JAX package's ``ipoke_tpu/parallel`` and the port's own
one-process runs.

The ranks are gloo worlds of 2 and 4 CPU processes, one spawn per world size
(``tests/torch_parallel_worker.py``); the cases read what the worlds
returned.  The sharding rules are held leaf for leaf against JAX's own
functions on the same tree (the port's tiny tree in JAX's layout through
``ckpt/jax_bridge.unbridge_second_stage``; JAX's rules read only shapes), on
conftest's 8 virtual CPU devices, without a compile.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from torch_parallel_faults import FAULTS, fault_case, verdict
from torch_parallel_worker import (World, gathered_train_case, mesh_case, micro_leg_case,
                                   sample_case, train_case)

from ipoke_tpu.parallel import distributed as jdist
from ipoke_tpu.parallel import mesh as jmesh
from ipoke_tpu.parallel import sharding as jsh
from ipoke_tpu.train import second_stage as jtrain
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage, unbridge_second_stage
from ipoke_tpu_torch.flows.macow import FlowSpec
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.parallel import distributed, dryrun
from ipoke_tpu_torch.parallel import sharding as psh
from ipoke_tpu_torch.parallel.mesh import Split
from ipoke_tpu_torch.train import second_stage as train_ss
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, flatten, np_tree, port_second_stage_spec

TOLS = dryrun.TRAIN_TOLS["cpu"]   # params: tests/test_zero_sharding.py's 2e-5

# (n_data, n_model, leg options) per world; the legs of a world share its
# one-process reference (the dry run's tiny model, its global batch)
LEGS = {
    2: [("dp-zero", 2, 1, {}), ("dp", 2, 1, {"zero_opt": False, "tp": False, "donate": False}),
        ("tp", 1, 2, {}), ("fsdp", 2, 1, {"fsdp": True}),
        ("fsdp-no-zero", 2, 1, {"fsdp": True, "zero_opt": False})],
    4: [("dp-tp-zero", 2, 2, {}), ("fsdp-tp", 2, 2, {"fsdp": True}), ("zero", 4, 1, {})],
}
CLIP = {"clip_grad_norm": 1e-3}   # below the tiny model's gradient norm: it clips
# the legs run again with a step of 2 microbatches, against the one-process
# microbatched step: in the world of 4 (global batch 4) each microbatch's rows
# lie on two ranks, and the flow's input has 16 augment channels, drawn per
# microbatch
MICRO = {2: [("dp-zero", 2, 1, {}), ("fsdp", 2, 1, {"fsdp": True}), ("tp", 1, 2, {})],
         4: [("zero-augment", 4, 1, {})]}


def _world(n):
    cases = [("mesh", mesh_case, {}),
             ("train", train_case, {"meshes": [(d, m, kw) for _, d, m, kw in LEGS[n]]}),
             ("micro", train_case, {"meshes": [(d, m, kw) for _, d, m, kw in MICRO[n]],
                                    "n_microbatches": 2, "augment": 16 if n == 4 else 0}),
             ("sample", sample_case, {})]
    if n == 2:
        cases += [("clip", train_case, dict(meshes=[(2, 1, {})], **CLIP)),
                  ("faults", fault_case, {}),
                  ("micro-leg", micro_leg_case, {"n_microbatches": 4})]
    return World(n, cases)


@pytest.fixture(scope="module")
def worlds():
    started = {n: _world(n) for n in (2, 4)}   # both at once
    return {n: w.result() for n, w in started.items()}


# ---------------------------------------------------------------------------
# process groups, mesh, batch placement
# ---------------------------------------------------------------------------

def test_torchrun_environment_detection(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.is_multi_host_env()
    assert distributed.maybe_initialize() is False
    assert distributed.process_info() == {"process_index": 0, "process_count": 1}
    distributed.barrier()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not distributed.is_multi_host_env()
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert distributed.is_multi_host_env()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert distributed.is_multi_host_env()
    assert distributed.default_backend("cpu") == "gloo"
    # JAX's own detection, for the record of what each package reads
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host-a,host-b")
    assert jdist.is_multi_host_env()


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_shapes_and_batch_rows(worlds, n):
    res = worlds[n]["mesh"]
    for r, x in enumerate(res):
        assert x["shape"] == {"data": n, "model": 1}
        assert x["shape2"] == {"data": n // 2, "model": 2}
        assert x["coords2"] == (r // 2, r % 2)     # row-major, as JAX reshapes its devices
        assert x["info"] == {"process_index": r, "process_count": n}
        rows = np.arange(4 * n * 3, dtype=np.float32).reshape(4 * n, 3)[8 * (r // 2):8 * (r // 2 + 1)]
        np.testing.assert_array_equal(x["rows"], rows)
        np.testing.assert_array_equal(x["placed"], rows)
        np.testing.assert_array_equal(x["prefetched"], rows)
        np.testing.assert_array_equal(x["replicated"], np.zeros(3, np.float32))
    # JAX's P("data") puts the same rows on data index i
    jm = jmesh.make_mesh(n_data=n // 2, n_model=2, devices=jax.devices()[:n])
    placed = jmesh.shard_batch(jm, {"x": np.arange(4 * n * 3, dtype=np.float32).reshape(4 * n, 3)})
    for shard in placed["x"].addressable_shards:
        i = (shard.index[0].start or 0) // 8
        np.testing.assert_array_equal(np.asarray(shard.data), res[2 * i]["rows"])


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_their_transposes(worlds, n):
    for r, x in enumerate(worlds[n]["mesh"]):
        assert float(x["all_reduce"][0]) == n * (n + 1)       # sum of 2 (r + 1)
        assert float(x["grad_all_reduce"][0]) == 2 * n        # transpose: a sum again
        assert float(x["grad_copy_to"][0]) == n * (n + 1) / 2  # identity forward, sum backward
        assert float(x["grad_reduce_from"][0]) == r + 1        # sum forward, identity backward
        assert "feed between 1 and 2 rows" in x["uneven"]


# ---------------------------------------------------------------------------
# the sharding rules, leaf for leaf against JAX's
# ---------------------------------------------------------------------------

SPECS = {"tiny": dryrun.tiny_spec(),
         "deep": replace(dryrun.tiny_spec(), flow=FlowSpec(
             num_steps=(3, 2, 1), in_channels=16, hidden_channels=64, h_channels=32, factor=8))}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, spec in SPECS.items():
        params = second_stage.init(prng.prng_key(0), spec, device="cpu", only=("flow",))
        out[name] = (spec, params, unbridge_second_stage(params, spec))
    return out


def _port_to_jax_axis():
    """port dim -> JAX axis of a 4-D and a 5-D kernel, learnt from the
    bridge's own layout function on shapes of distinct sizes."""
    out = {}
    for shape in ((2, 3, 5, 7), (2, 3, 5, 7, 11)):
        jax_shape = core.to_hwio(torch.empty(shape)).shape
        out[len(shape)] = {d: jax_shape.index(s) for d, s in enumerate(shape)}
    return out


_AXES = _port_to_jax_axis()


def _port_marks(params, rule_tree):
    """{JAX path: (axis, JAX axis) or None} from the port's placements; the
    steps of a stack must agree."""
    marks = {}

    def walk(p, r, path, stacked):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], r[k], path + (k,), stacked)
        elif isinstance(p, list):
            for i, (a, b) in enumerate(zip(p, r)):
                if path[-1] == "steps":
                    walk(a, b, path, True)
                else:
                    walk(a, b, path + (str(i),), stacked)
        else:
            mark = None
            if r is not None:
                assert isinstance(r, Split)
                kernel = path[-1] in ("w", "v") and p.dim() in (4, 5)
                ax = _AXES[p.dim()][r.dim] if kernel else r.dim
                mark = (r.axis, ax + stacked)
            key = "/".join(path)
            assert marks.setdefault(key, mark) == mark, key
    walk(params, rule_tree, (), False)
    return marks


def _jax_marks(sh_tree, below=None):
    """{path: (axis, axis index) or None} of JAX's NamedSharding tree; with
    ``below``, only the leaves under that attribute (an optimizer moment),
    their paths relative to it."""
    marks = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh_tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path]
        if below is not None:
            if below not in keys:
                continue
            keys = keys[keys.index(below) + 1:]
        spec = tuple(s.spec)
        named = [(a, i) for i, a in enumerate(spec) if a is not None]
        assert len(named) <= 1
        marks["/".join(keys)] = named[0] if named else None
    return marks


def _float_only(marks, params):
    names = set()

    def walk(p, path, stacked):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], path + (k,), stacked)
        elif isinstance(p, list):
            for i, a in enumerate(p):
                walk(a, path if path[-1] == "steps" else path + (str(i),), stacked)
        elif p.is_floating_point():
            names.add("/".join(path))
    walk(params, (), False)
    return {k: v for k, v in marks.items() if k in names}


@pytest.mark.parametrize("spec_name", ["tiny", "deep"])
@pytest.mark.parametrize("sizes", [(4, 2), (2, 1)], ids=["4x2", "2x1"])
def test_rules_match_jax_leaf_for_leaf(trees, spec_name, sizes):
    spec, params, jtree = trees[spec_name]
    jm = jmesh.make_mesh(n_data=sizes[0], n_model=sizes[1],
                         devices=jax.devices()[:sizes[0] * sizes[1]])
    pm = {"data": sizes[0], "model": sizes[1]}
    min_width = 32
    tp_j = jsh.flow_param_shardings(jm, jtree, min_width=min_width)
    tp_p = psh.flow_param_shardings(pm, params, min_width=min_width)
    assert _port_marks(params, tp_p) == _jax_marks(tp_j)
    for min_size in (512, 8192):
        fs_j = jsh.fsdp_param_shardings(jm, jtree, min_size=min_size, tp_shardings=tp_j)
        fs_p = psh.fsdp_param_shardings(pm, params, min_size=min_size, tp_shardings=tp_p)
        assert _port_marks(params, fs_p) == _jax_marks(fs_j)
        opt = jtrain.make_optimizer(jtree, lr=1e-3)
        zero_j = jsh.zero_opt_state_shardings(jm, jax.eval_shape(opt.init, jtree),
                                              min_size=min_size)
        zero_p = psh.zero_opt_state_shardings(pm, params, min_size=min_size)
        want = _jax_marks(zero_j, below="mu")
        assert want and _float_only(_port_marks(params, zero_p), params) == want


def test_tp_rule_marks_only_the_priors_nice_convs(trees):
    """JAX's rule needs 4-D leaves; a stacked step's kernels are 5-D there, so
    only the priors' NICE couplings split over model."""
    spec, params, _ = trees["deep"]
    marks = _port_marks(params, psh.flow_param_shardings({"model": 2}, params, min_width=32))
    split = sorted(k for k, v in marks.items() if v is not None)
    levels = len(spec.flow.num_steps)
    assert split == sorted(f"flow/levels/{i}/prior/coupling/net/{c}"
                           for i in range(levels) for c in ("conv1/w", "conv2/w", "conv3/v"))
    assert {marks[k] for k in split} == {("model", 3), ("model", 2)}


def test_shard_train_setup_takes_only_a_step_of_make_train_step():
    with pytest.raises(TypeError, match="make_train_step"):
        train_ss.shard_train_setup(None, train_ss.TrainState(0, {}, []), lambda *a: a)


def test_microbatch_parts_cover_each_rank_rows_once():
    """A rank's rows split at the microbatches' bounds, a part straddling two
    ranks included; a batch that does not split raises."""
    assert train_ss.microbatch_parts(0, 4, 1, 8) == [(0, 0, 4)]
    assert train_ss.microbatch_parts(4, 4, 2, 4) == [(1, 4, 8)]
    # 6 rows over 2 ranks in 3 microbatches of 2: microbatch 1 lies on both
    assert train_ss.microbatch_parts(0, 3, 3, 2) == [(0, 0, 2), (1, 2, 3)]
    assert train_ss.microbatch_parts(3, 3, 3, 2) == [(1, 3, 4), (2, 4, 6)]
    assert train_ss.microbatch_rows(6, 3) == 2
    with pytest.raises(ValueError, match="microbatches"):
        train_ss.microbatch_rows(6, 4)


# ---------------------------------------------------------------------------
# the sharded step and the sharded sampler against the one-process runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,i", [(n, i) for n in LEGS for i in range(len(LEGS[n]))],
                         ids=[f"{n}:{leg[0]}" for n in LEGS for leg in LEGS[n]])
def test_sharded_step_matches_one_process(worlds, n, i):
    name, d, m, kw = LEGS[n][i]
    for r, rep in enumerate(x[i] for x in worlds[n]["train"]):
        assert rep["mesh"] == {"data": d, "model": m}
        assert all(rep["errs"][k] <= tol for k, tol in TOLS.items()), (name, r, rep["errs"])
        assert np.isfinite(rep["flow_loss"])
        if kw.get("fsdp"):
            assert rep["fsdp_sharded_params"] > 0
        if m > 1 and kw.get("tp", True):
            assert rep["tp_sharded_params"] == 6      # 2 levels x the prior's conv1/2/3
        if kw.get("zero_opt", True):
            assert rep["zero_sharded_moments"] > 0


@pytest.mark.parametrize("n,i", [(n, i) for n in MICRO for i in range(len(MICRO[n]))],
                         ids=[f"{n}:{leg[0]}" for n in MICRO for leg in MICRO[n]])
def test_sharded_microbatched_step_matches_one_process(worlds, n, i):
    """``n_microbatches=2`` under data parallel + ZeRO-1, FSDP and tensor
    parallel against the one-process microbatched step."""
    name, d, m, kw = MICRO[n][i]
    for r, rep in enumerate(x[i] for x in worlds[n]["micro"]):
        assert rep["mesh"] == {"data": d, "model": m} and rep["n_microbatches"] == 2
        assert all(rep["errs"][k] <= tol for k, tol in TOLS.items()), (name, r, rep["errs"])
        assert np.isfinite(rep["flow_loss"])
        if kw.get("fsdp"):
            assert rep["fsdp_sharded_params"] > 0
        if m > 1:
            assert rep["tp_sharded_params"] == 6


def test_dryrun_micro_leg_accumulates_microbatches_on_each_rank(worlds):
    """``dryrun.micro_leg``, the card's microbatched leg, in the world of 2
    with 4 microbatches of 1 row: each rank runs two and sums their
    gradients, held against its one-process microbatched run."""
    for r, rep in enumerate(worlds[2]["micro-leg"]):
        assert rep["mesh"] == {"data": 2, "model": 1} and rep["n_microbatches"] == 4
        assert all(rep["errs"][k] <= tol for k, tol in TOLS.items()), (r, rep["errs"])
        assert rep["ref_s"] > 0 and rep["leg_s"] > 0 and np.isfinite(rep["flow_loss"])


def test_sharded_step_clips_by_the_whole_norm(worlds):
    for rep in (x[0] for x in worlds[2]["clip"]):
        assert all(rep["errs"][k] <= tol for k, tol in TOLS.items()), rep["errs"]


@pytest.mark.parametrize("fault", FAULTS)
def test_train_leg_check_calls_a_planted_fault_wrong(worlds, fault):
    """tests/torch_parallel_faults.py in the world of 2: the sound
    data-parallel leg is held, each fault is called wrong on every rank."""
    per_rank = worlds[2]["faults"]
    assert not verdict(per_rank), verdict(per_rank)
    for legs in per_rank:
        assert legs["sound"]["held"] and not legs[fault]["held"], legs[fault]["errs"]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_forward_sample_matches_one_process(worlds, n):
    for rep in worlds[n]["sample"]:
        for k in ("z_fixed", "z_drawn"):
            assert rep[k]["finite"] and rep[k]["max_abs_err"] < dryrun.SAMPLE_TOL, rep


def test_dryrun_steps_per_level_cuts_only_the_train_legs():
    """``steps_per_level`` cuts the train legs' flow (and their one-process
    runs) to that many MaCowSteps per level, every level and width kept; the
    sampler keeps the flagship's full depth."""
    full = dryrun.Rank(0, 2, CPU, full=True)
    cut = dryrun.Rank(0, 2, CPU, full=True, steps_per_level=1)
    levels = len(full.spec.flow.num_steps)
    assert full.train_spec == full.spec == cut.spec and sum(full.spec.flow.num_steps) == 50
    assert cut.train_spec.flow.num_steps == (1,) * levels
    assert replace(cut.train_spec, flow=replace(cut.train_spec.flow,
                                                num_steps=full.spec.flow.num_steps)) == full.spec


@pytest.mark.slow
def test_sharded_step_matches_jax_shard_train_setup():
    """The port's data-parallel + ZeRO-1 step over 2 ranks (donate=False)
    against JAX's ``shard_train_setup`` (donate=False, zero_min_size=512) on
    2 of conftest's virtual devices, 2 steps from the same params on the same
    batch and keys: params, their change and metrics (relative to 1 +
    |m_jax|) within the dry run's CPU tolerances."""
    _against_jax_shard_train_setup(1)


@pytest.mark.slow
def test_sharded_microbatched_step_matches_jax_shard_train_setup():
    """As above, both steps made with ``n_microbatches=2``: JAX jits its
    ``lax.scan`` over the microbatches on the mesh."""
    _against_jax_shard_train_setup(2)


def _against_jax_shard_train_setup(n_microbatches):
    from test_zero_sharding import _tiny_spec   # JAX's dry-run model

    res = World(2, [("train", gathered_train_case, {"n_microbatches": n_microbatches})],
                timeout=300).result()["train"]
    spec, jspec = dryrun.tiny_spec(), _tiny_spec()
    me = dryrun.Rank(0, 2, CPU, full=False)
    assert port_second_stage_spec(jspec, mcf_backend="cuda_unit") == spec
    params = dryrun.params_for(me, 0)
    start = train_ss.split_params(params)[0]
    trainable, frozen = jtrain.split_params(
        jax.tree_util.tree_map(jax.numpy.asarray, unbridge_second_stage(params, spec)))
    opt = jtrain.make_optimizer(trainable, lr=dryrun.LR, warmup_steps=0, total_steps=100)
    jm = jmesh.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    placed, step = jtrain.shard_train_setup(
        jm, jtrain.init_state(trainable, opt),
        jtrain.make_train_step(jspec, frozen, opt, n_microbatches=n_microbatches),
        zero_opt=True, donate=False, zero_min_size=512)
    batch = jmesh.shard_batch(jm, {k: v.numpy() for k, v in
                                   dryrun.global_batch(me, me.batch_rows).items()})
    for i in range(dryrun.STEPS):
        placed, metrics = step(placed, batch, jax.random.fold_in(jax.random.PRNGKey(1), i))
    want = flatten(bridge_second_stage(np_tree(placed.params), spec, device=CPU))
    start = flatten(start)
    for r, x in enumerate(res):
        assert x["kept"]
        got = {k: v for k, v in flatten(_torch_tree(x["params"])).items()
               if v.is_floating_point()}
        assert got.keys() <= want.keys() and len(got) > 20
        p_err = max(dryrun._max_err(g, want[k]) for k, g in got.items())
        u_err = max(dryrun._norm_err(g - start[k], want[k] - start[k]) for k, g in got.items())
        m_err = max(abs(x["metrics"][k] - float(v)) / (1 + abs(float(v)))
                    for k, v in metrics.items())
        assert metrics.keys() == x["metrics"].keys()
        assert (p_err <= TOLS["params"] and u_err <= TOLS["update"]
                and m_err <= TOLS["metrics"]), (r, p_err, u_err, m_err)


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_torch_tree(v) for v in t]
    return torch.from_numpy(np.asarray(t))
