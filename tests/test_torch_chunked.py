"""The port's per-level flow trainer (``train/chunked.py``), ``adafactor``
and the flow's ``remat``, on the CPU.

* The per-level chain against the port's one-graph step with the same
  optimizer (no clipping) over two steps at ``tests/test_chunked.py``'s
  ``SPEC``: losses within 1e-6 relative, params within ``PARAM_TOL``; the
  whole trainer (embedding included) against ``make_train_step`` on the
  dry run's tiny second stage, also over two steps.
* The chain's gradients against JAX's ``chunked.flow_loss_and_grads`` on
  the same params (per-level jitted functions, ~14 s of compile here, so
  ``-m slow``): per leaf within 2e-4 relative to 1 + max|g|, the loss
  within 1e-5.
* ``adafactor`` against ``optax.adafactor`` under ``multi_transform(...,
  set_to_zero)`` over three updates on a tree with a factored leaf, an
  unfactored 2-D leaf, a stacked 5-D leaf (and the same leaf as the port's
  list of steps), a scalar and an integer leaf: within 1e-6 relative to the
  largest update, the integer leaf bitwise unchanged.
* ``remat=True`` against ``remat=False``: loss and gradients within 1e-6,
  the inverse unchanged.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.flows.macow import FlowSpec as JaxFlowSpec
from ipoke_tpu.train import chunked as jchunked
from ipoke_tpu.train.second_stage import _float_labels
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_flow, unbridge_flow
from ipoke_tpu_torch.flows import macow, transformer
from ipoke_tpu_torch.flows.loss import flow_loss
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.parallel.dryrun import tiny_spec
from ipoke_tpu_torch.train import chunked
from ipoke_tpu_torch.train import second_stage as train
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.synth import set_flow_output_gains
from torch_port_util import CPU, clone_tree, flatten, np_tree, port_flow_spec

JSPEC = JaxFlowSpec(num_steps=(2, 1), in_channels=8, hidden_channels=32, h_channels=12, factor=4)
SPEC = port_flow_spec(JSPEC)
PARAM_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 2e-4     # the slice's f32 tolerance, per leaf relative to 1 + max|g_ref|
ADA_TOL = 1e-6
REMAT_TOL = 1e-6


def _flow(spec=SPEC, seed=0):
    """The port's init (JAX's draw) with the output convs' gains at 0.1, so
    no coupling is the identity."""
    return set_flow_output_gains(macow.init_multiscale(prng.prng_key(seed), spec), 0.1)


def _inputs(b=2, seed=1, c=8, hc=12):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((b, 8, 8, c)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((b, 8, 8, hc)).astype(np.float32)))


def _opt():
    return train.make_optimizer(lr=1e-3, weight_decay=1e-2, warmup_steps=1, total_steps=10)


def _max_rel(a, b):
    return float((a - b).abs().max() / (1 + b.abs().max()))


def test_per_level_chain_equals_one_graph_step_at_spec():
    """Two steps of the chain with per-level optimizers against two of the
    one-graph loss, autograd and one optimizer over the whole flow."""
    x, h = _inputs()
    mono, chain = _flow(), _flow()
    for p in train.float_leaves(mono) + train.float_leaves(chain):
        p.requires_grad_(True)
    opt = _opt()
    opt_state = opt.init(mono)
    level_opts = [_opt() for _ in chain["levels"]]
    level_states = [o.init(lvl) for o, lvl in zip(level_opts, chain["levels"])]

    def update(i, params, grads):
        with torch.no_grad():
            torch._foreach_add_(params, level_opts[i].update(grads, level_states[i], params))

    for _ in range(2):
        out, logdet = transformer.forward(mono, SPEC, x, h)
        loss_m, logs = flow_loss(out, logdet)
        p = train.float_leaves(mono)
        grads = [torch.zeros_like(q) if g is None else g
                 for q, g in zip(p, torch.autograd.grad(loss_m, p, allow_unused=True))]
        loss_m = loss_m.detach()
        with torch.no_grad():
            torch._foreach_add_(p, opt.update(grads, opt_state, p))
        loss_c, nll, logdet_total = chunked.flow_loss_and_grads(chain["levels"], SPEC, x, h, update)
        assert abs(float(loss_c) - float(loss_m)) <= LOSS_TOL * abs(float(loss_m))
        assert abs(float(nll) - float(logs["nll_loss"])) <= LOSS_TOL * abs(float(nll))
        assert abs(float(-logdet_total / 2) - float(logs["nlogdet_loss"])) <= LOSS_TOL * (
            1 + abs(float(logs["nlogdet_loss"])))
    for a, b in zip(train.float_leaves(chain), train.float_leaves(mono)):
        assert float((a - b).detach().abs().max()) <= PARAM_TOL
    assert any(float((a - b).detach().abs().max()) > 1e-4
               for a, b in zip(train.float_leaves(chain), train.float_leaves(_flow())))


def test_per_level_trainer_equals_make_train_step():
    """The whole trainer (embed, chain, per-level updates, JAX's three
    metrics) against ``make_train_step`` on the tiny second stage with the
    flow of two levels of 2 and 1 steps, two steps on one batch."""
    spec = tiny_spec()
    spec = replace(spec, flow=replace(spec.flow, num_steps=(2, 1), factor=4, mcf_backend="scan"))
    params = second_stage.init(prng.prng_key(0), spec, CPU)
    params["flow"] = set_flow_output_gains(params["flow"], 0.1)
    trainable, frozen = train.split_params(params)
    rng = np.random.default_rng(3)
    batch = {"images": torch.from_numpy(0.5 * rng.standard_normal((2, 4, 64, 64, 3)).astype(np.float32)),
             "poke": torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))}
    mono_step = train.make_train_step(spec, frozen, _opt())
    mono = train.init_state(clone_tree(trainable), mono_step.optimizer)
    per_level = chunked.make_per_level_trainer(spec.flow, spec, frozen, lambda lvl: _opt())
    state = per_level.init_state(clone_tree(trainable)["flow"])
    for i in range(2):
        mono, m_mono = mono_step(mono, batch, prng.prng_key(i))
        state, m_lvl = per_level(state, batch)
        assert set(m_lvl) == set(chunked.METRICS)
        for k in chunked.METRICS:
            assert abs(float(m_lvl[k]) - float(m_mono[k])) <= LOSS_TOL * (1 + abs(float(m_mono[k]))), k
    assert state.step == 2
    for a, b in zip(train.float_leaves({"levels": state.levels}), train.float_leaves(mono.params)):
        assert float((a - b).detach().abs().max()) <= PARAM_TOL


@pytest.mark.slow
def test_per_level_gradients_match_jax():
    """The chain's per-level gradients against JAX's per-level VJP chain."""
    flow = _flow()
    x, h = _inputs()
    jparams = jax.tree_util.tree_map(jnp.asarray, unbridge_flow(flow))
    fns = jchunked._LevelFns(JSPEC)
    loss_ref, grads_ref, _ = jchunked.flow_loss_and_grads(fns, jparams, jnp.asarray(x.numpy()),
                                                          jnp.asarray(h.numpy()))
    for p in train.float_leaves(flow):
        p.requires_grad_(True)
    got = {}
    loss, _, _ = chunked.flow_loss_and_grads(
        flow["levels"], SPEC, x, h, lambda i, params, grads: got.update({i: grads}))
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    assert sorted(got) == [0, 1]
    ref = bridge_flow(np_tree(grads_ref), CPU)
    n = 0
    for i, level in enumerate(flow["levels"]):
        names = [k for k, v in flatten(level).items() if v.is_floating_point()]
        want = flatten(ref["levels"][i])
        assert len(names) == len(got[i])
        for name, g in zip(names, got[i]):
            assert _max_rel(g, want[name]) <= GRAD_TOL, (i, name)
            n += 1
    assert n == len(train.float_leaves(flow))


# ---------------------------------------------------------------------------
# adafactor
# ---------------------------------------------------------------------------

ADA_SHAPES = {"factored": (130, 140), "small": (7, 9), "stacked": (3, 2, 3, 160, 130),
              "scalar": ()}


def _ada_tree(seed=0):
    rng = np.random.default_rng(seed)
    tree = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in ADA_SHAPES.items()}
    tree["perm"] = np.arange(7, dtype=np.int32)[::-1].copy()
    return tree


def _port_tree(tree, as_steps):
    """The numpy tree as the port holds it; ``as_steps``: the stacked leaf
    as a level's list of steps (the port's flow layout)."""
    out = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    if as_steps:
        stacked = out.pop("stacked")
        out["steps"] = [{"w": stacked[s].clone()} for s in range(stacked.shape[0])]
    return out


def _port_leaf(tree, k, as_steps):
    if as_steps and k == "stacked":
        return torch.stack([s["w"] for s in tree["steps"]]).numpy()
    return tree[k].numpy()


@pytest.mark.parametrize("as_steps", [False, True], ids=["stacked_leaf", "list_of_steps"])
def test_adafactor_matches_optax(as_steps):
    tree = _ada_tree()
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    jopt = optax.multi_transform({"train": optax.adafactor(1e-2), "freeze": optax.set_to_zero()},
                                 _float_labels(jparams))
    jstate = jopt.init(jparams)
    params = _port_tree(tree, as_steps)
    opt = train.adafactor(1e-2)
    state = opt.init(params)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = {k: np.asarray(0.1 * rng.standard_normal(v.shape), np.float32) for k, v in tree.items()
             if k != "perm"}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jg["perm"] = jnp.zeros((7,), jnp.int32)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        pg = _port_tree({**g, "perm": tree["perm"]}, as_steps)
        leaves = train.float_leaves(params)
        grads = train.float_leaves(pg)
        with torch.no_grad():
            torch._foreach_add_(leaves, opt.update(grads, state, leaves))
        for k in ADA_SHAPES:
            want = np.asarray(jparams[k])
            got = _port_leaf(params, k, as_steps)
            moved = np.abs(want - tree[k]).max()
            assert moved > 0, k
            assert np.abs(got - want).max() <= ADA_TOL * max(1.0, np.abs(want).max()), k
            assert np.abs((got - tree[k]) - (want - tree[k])).max() <= ADA_TOL * moved * 10, k
    assert params["perm"].dtype == torch.int32
    assert np.array_equal(params["perm"].numpy(), tree["perm"])


def test_adafactor_blocks_follow_the_stacked_layout():
    """The port's list of steps is one block, as JAX's stacked leaf is; the
    factoring follows optax's choice of axes."""
    tree = _port_tree(_ada_tree(), as_steps=True)
    blocks = train.stacked_blocks(tree)
    names = ["factored", "small", "scalar", "steps0", "steps1", "steps2"]
    assert [[names[i] for i in b] for b in blocks] == [
        ["factored"], ["small"], ["scalar"], ["steps0", "steps1", "steps2"]]
    assert train._factored_dims((3, 2, 3, 160, 130)) == (4, 3)
    assert train._factored_dims((130, 140)) == (0, 1)
    assert train._factored_dims((7, 9)) is None
    assert train._factored_dims((512,)) is None


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_remat_leaves_loss_gradients_and_inverse_unchanged():
    x, h = _inputs()
    results = {}
    for remat in (False, True):
        spec = replace(SPEC, remat=remat)
        flow = _flow(spec)
        p = train.float_leaves(flow)
        for q in p:
            q.requires_grad_(True)
        out, logdet = transformer.forward(flow, spec, x, h)
        loss, _ = flow_loss(out, logdet)
        grads = torch.autograd.grad(loss, p, allow_unused=True)
        with torch.no_grad():
            inv = transformer.reverse(flow, spec, out, h)
        results[remat] = (loss.detach(), grads, inv)
    (l0, g0, i0), (l1, g1, i1) = results[False], results[True]
    assert abs(float(l1) - float(l0)) <= REMAT_TOL * abs(float(l0))
    for a, b in zip(g1, g0):
        assert (a is None) == (b is None)
        if a is not None:
            assert _max_rel(a, b) <= REMAT_TOL
    assert torch.equal(i1, i0)
    assert float((i0 - x).abs().max()) <= 1e-4
