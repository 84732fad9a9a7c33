"""The port's sequence-parallel motion encoder (``ipoke_tpu_torch/parallel/
seqpar.py``) against the JAX package's dense ``motion_encoder.apply``, run
eagerly: a video's time axis split over gloo worlds of 2 and 4 CPU
processes (``tests/torch_parallel_worker.py``), alone and beside a ``data``
axis; forward at JAX's rtol 2e-4 / atol 2e-5 and the gradient at 5e-3 /
1e-4 (``tests/test_seqpar.py``).  The JAX references run while the worlds
do.  The gradient is held against the port's dense gradient in float64,
which ``-m slow`` holds against JAX's eager gradient in float64 (2.7e-13
apart): JAX's float32 weight gradients of the 3D convs lie up to 0.135 from
float64 on an x86 CPU with AMX (conv1/w, max 24.4), the port's 4.7e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_worker import ENCODER, VIDEO, World, encoder_and_video, seqpar_case

from ipoke_tpu.models import motion_encoder as jme
from ipoke_tpu.parallel import seqpar as jseqpar
from ipoke_tpu_torch.models import motion_encoder
from ipoke_tpu_torch.models.motion_encoder import MotionEncoderSpec
from ipoke_tpu_torch.nn import core
from ipoke_tpu_torch.parallel import seqpar

SPEC, JSPEC = MotionEncoderSpec(**ENCODER), jme.MotionEncoderSpec(**ENCODER)
B, T = VIDEO[:2]
RNG = 7
# (n_data, n_seq, key or None, gradient) per world
RUNS = {2: [("seq", 1, 2, None, True), ("seq-rng", 1, 2, RNG, False)],
        4: [("data-seq", 2, 2, None, True), ("seq-rng", 1, 4, RNG, False),
            ("data-seq-rng", 2, 2, RNG, False)]}


def _np_tree(t):
    if isinstance(t, dict):
        return {k: (core.to_hwio(v).numpy() if k == "w" else _np_tree(v)) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return t.numpy()


@pytest.fixture(scope="module")
def setup():
    worlds = {n: World(n, [(name, seqpar_case, dict(n_data=d, n_seq=s, key=k, grad=g))
                           for name, d, s, k, g in runs]) for n, runs in RUNS.items()}
    _, params, x = encoder_and_video()
    # while the worlds run: the JAX package's dense encoder, eagerly, and the
    # port's dense gradient in float64
    jparams = jax.tree_util.tree_map(jnp.asarray, _np_tree(params))
    dense = jax.tree_util.tree_map(np.asarray, jme.apply(jparams, jnp.asarray(x), JSPEC))
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(RNG), dense[2].shape))
    dense_rng = (eps * np.exp(0.5 * dense[2]) + dense[1],) + tuple(dense[1:])
    return {"worlds": {n: w.result() for n, w in worlds.items()}, "dense": dense,
            "dense_rng": dense_rng, "grads": _dense_grads_f64(params, x)}


def _loss(mu, logvar):
    return (mu ** 2).sum() + torch.tanh(logvar).sum()


def _dense_grads_f64(params, x):
    """The port's dense gradient in float64, as a tree of numpy arrays."""
    p64 = _map(params, lambda t: t.double().requires_grad_(True))
    leaves = []
    _map(p64, leaves.append)
    _, mu, logvar = motion_encoder.apply(p64, torch.from_numpy(x).double(), SPEC)
    grads = iter(torch.autograd.grad(_loss(mu, logvar), leaves))
    return _map(p64, lambda t: next(grads).numpy())


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _rows(a, d, n_data):
    k = a.shape[0] // n_data
    return np.asarray(a)[d * k:(d + 1) * k]


def test_plan_check_follows_jax():
    assert seqpar.temporal_strides(SPEC) == jseqpar.temporal_strides(JSPEC) == [2, 2, 2, 2]
    assert seqpar.check_plan(SPEC, 64, 4) == jseqpar.check_plan(JSPEC, 64, 4)
    assert seqpar.shortest_length(SPEC, 4) == 64
    for t, n in ((10, 4), (32, 4), (48, 2)):
        with pytest.raises(ValueError) as want:
            jseqpar.check_plan(JSPEC, t, n)
        with pytest.raises(ValueError) as got:
            seqpar.check_plan(SPEC, t, n)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,i", [(n, i) for n in RUNS for i in range(len(RUNS[n]))],
                         ids=[f"{n}:{r[0]}" for n in RUNS for r in RUNS[n]])
def test_forward_equals_the_dense_encoder(setup, n, i):
    name, n_data, n_seq, key, _ = RUNS[n][i]
    dense = setup["dense_rng"] if key is not None and n_data == 1 else setup["dense"]
    for r, res in enumerate(setup["worlds"][n][name]):
        d = res["data_index"]
        assert d == r // n_seq
        for got, want in zip((res["z"], res["mu"], res["logvar"]), dense):
            if key is not None and n_data > 1 and got is res["z"]:
                # each data shard draws from the key folded with its index
                k = jax.random.fold_in(jax.random.PRNGKey(key), d)
                lv, m = _rows(dense[2], d, n_data), _rows(dense[1], d, n_data)
                want = np.asarray(jax.random.normal(k, lv.shape) * jnp.exp(0.5 * lv) + m)
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
                continue
            np.testing.assert_allclose(got, _rows(want, d, n_data), rtol=2e-4, atol=2e-5)


def _compare(got, want, path=""):
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            _compare(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _compare(a, b, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("n,name", [(2, "seq"), (4, "data-seq")])
def test_gradient_equals_the_dense_encoders(setup, n, name):
    for res in setup["worlds"][n][name]:
        _compare(res["grads"], setup["grads"])


@pytest.mark.slow
def test_dense_gradient_in_float64_equals_jaxs():
    """The reference of the gradient test against JAX's eager gradient, both
    in float64 (~15 s of eager dispatch)."""
    _, params, x = encoder_and_video()

    def loss(p, v):
        _, mu, logvar = jme.apply(p, v, JSPEC)
        return jnp.sum(mu ** 2) + jnp.sum(jnp.tanh(logvar))

    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), _np_tree(params))
        want = jax.grad(loss)(jp, jnp.asarray(x, jnp.float64))
        want = _map(want, np.asarray)
    got = _dense_grads_f64(params, x)

    def walk(g, w, path=""):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(g, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}/{i}")
        else:
            if path.endswith("/w"):
                w = core.from_hwio(torch.from_numpy(np.array(w))).numpy()
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=path)
    walk(got, want)
