"""PWC-lite in the port (``ipoke_tpu_torch/ops/pwc.py``) against the JAX
package's ``ipoke_tpu/ops/pwc.py`` on the CPU:

* ``init_pwc`` from the same key: every conv drawn from JAX's subkey in
  JAX's order and shape, the same ``keystr`` leaves, and the widest conv's
  numbers within one ulp of its bound of JAX's (XLA rounds the uniform's
  ``u * (hi - lo) + lo`` once, torch twice), biases zero;
* the three synthetic generators (a Python displacement and, as in the fit,
  an f32 one) within 1e-5 * (1 + max|ref|): the align-corners resize of
  each package computes its interpolation weights in f32 its own way, ~3e-6
  off the exact resize apiece; the occlusion bands equal;
* ``pwc_flow_levels``, ``multiscale_epe_loss`` and its gradients at B=2,
  32^2, within 1e-4 * (1 + max|ref|) (one JAX reference; ``pwc_flow``
  through ``compute_flows`` in tests/test_torch_prepare.py);
* one Adam step of the fit against optax's ``adam(1e-3)`` update;
* ``pwc_lite.npz`` written by each package and read by the other, bitwise,
  with JAX's key strings; ``default_params`` loads the file when present
  and otherwise fits from PRNGKey(1234), writing nothing, as JAX's;
  ``data/prepare.fit_pwc_weights`` writes a fit only once it passes
  ``validate_fit``, fitting again from other keys where one does not;
* ``reproducible`` puts the caller's settings back, and the flow's
  upsampling gives F.interpolate's values and gradients.

``-m slow``: ``train_synthetic(steps=5, batch=2, size=32)`` in both
packages; JAX's own fit from PRNGKey(1234) under the guards of
``tests/test_pwc.py`` (``pwc.regime_guards``; its values printed); and the
port's whole 900-step fit from PRNGKey(0) on the CPU under those guards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.nn import core as jnc
from ipoke_tpu.ops import pwc as jpwc
from ipoke_tpu_torch.data import prepare
from ipoke_tpu_torch.nn.core import to_hwio
from ipoke_tpu_torch.ops import pwc
from ipoke_tpu_torch.utils import prng

TOL = 1e-4
GEN_TOL = 1e-5


def _np(tree):
    """The port's tree as JAX's: numpy leaves, HWIO kernels."""
    return jax.tree_util.tree_map(
        lambda t: (to_hwio(t) if t.dim() == 4 else t).detach().numpy().copy(), tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimisation level 0,
    which takes ~30% less compile time; the numbers differ from the
    optimised build's by rounding only."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _close(ref, out, tol=TOL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape
    err = np.abs(ref - out).max()
    assert err <= tol * (1 + np.abs(ref).max()), f"max |diff| {err:.3g}"


def test_init_pwc_draws_jax_keys_and_numbers(monkeypatch):
    """Every conv drawn from JAX's key in JAX's order and shape (JAX's draw
    recorded, not computed), then the numbers of the widest conv: within one
    ulp of its bound, where XLA rounds ``u * (hi - lo) + lo`` once."""
    drawn = {"jax": [], "port": []}

    def record(pkg, key, shape, device=None):
        drawn[pkg].append((tuple(int(v) for v in np.asarray(key)), tuple(shape)))
        return jnp.zeros(shape) if pkg == "jax" else torch.zeros(shape)

    with monkeypatch.context() as m:
        m.setattr(jpwc, "kaiming_uniform_torch_default", lambda k, s: record("jax", k, s))
        m.setattr(pwc, "kaiming_uniform_torch_default", lambda k, s, d: record("port", k, s))
        ref = _flat(jpwc.init_pwc(jax.random.PRNGKey(3)))
        zeros = dict(pwc._flatten(_np(pwc.init_pwc(prng.prng_key(3)))))
    assert drawn["port"] == drawn["jax"] and len(drawn["jax"]) == 24
    assert sorted(ref) == sorted(zeros) and not any(v.any() for v in zeros.values())

    params = dict(pwc._flatten(_np(pwc.init_pwc(prng.prng_key(3)))))
    key, shape = max(drawn["jax"], key=lambda d: np.prod(d[1]))
    widest = next(k for k, v in params.items() if v.shape == shape)
    want = np.asarray(jax.jit(jnc.kaiming_uniform_torch_default, static_argnums=1)(
        jnp.asarray(key, jnp.uint32), shape))
    assert np.abs(params[widest] - want).max() <= np.spacing(np.abs(want).max())
    assert not any(v.any() for k, v in params.items() if k.endswith("['b']"))


def test_synthetic_generators_match_jax():
    md = np.float32(7.3)

    def gens(key, md):
        return (jpwc.synthetic_pair(key, 2, 32, 32, 8.0), jpwc.synthetic_pair(key, 2, 32, 32, md),
                jpwc.synthetic_pair_rotation(key, 2, 32, 32, 12.0),
                jpwc.synthetic_pair_layered(key, 2, 32, 32, md))

    ref = _run(gens, jax.random.PRNGKey(5), md)
    key = prng.prng_key(5)
    out = (pwc.synthetic_pair(key, 2, 32, 32, 8.0), pwc.synthetic_pair(key, 2, 32, 32, md),
           pwc.synthetic_pair_rotation(key, 2, 32, 32, 12.0),
           pwc.synthetic_pair_layered(key, 2, 32, 32, md))
    for r, o in zip(ref, out):
        for a, b in zip(r[:3], o[:3]):
            _close(a, b, GEN_TOL)
    np.testing.assert_array_equal(np.asarray(ref[3][3]), out[3][3].numpy())


def test_prng_draws_equal_single_draws_bitwise():
    """The generators' one-pass ``prng.draws`` gives ``prng.normal`` and
    ``prng.uniform`` of each request, bitwise."""
    reqs = [("normal", prng.prng_key(1), (2, 12, 12, 3)), ("uniform", prng.prng_key(2), (2, 1, 1, 2), -7.5, 7.5),
            ("normal", prng.fold_in(prng.prng_key(3), 9), (5,)), ("uniform", prng.prng_key(4), (3, 2), 0.3, 0.7)]
    for r, got in zip(reqs, prng.draws(reqs)):
        want = prng.normal(r[1], r[2]) if r[0] == "normal" else prng.uniform(r[1], r[2], r[3], r[4])
        assert got.shape == want.shape and torch.equal(got, want)


def _batch():
    img1, img2, gt = pwc.synthetic_pair(prng.prng_key(11), 2, 32, 32, 6.0)
    return img1.numpy(), img2.numpy(), gt.numpy()


def test_levels_loss_and_gradients_match_jax():
    params = pwc.init_pwc(prng.prng_key(3))
    img1, img2, gt = _batch()

    def loss_and_levels(p, a, b, g):
        return jpwc.multiscale_epe_loss(p, a, b, g), jpwc.pwc_flow_levels(p, a, b)

    (loss_ref, levels_ref), grads_ref = _run(jax.value_and_grad(loss_and_levels, has_aux=True),
                                             _np(params), img1, img2, gt)
    leaves = pwc.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    t1, t2, tg = (torch.from_numpy(a) for a in (img1, img2, gt))
    for r, o in zip(levels_ref, pwc.pwc_flow_levels(params, t1, t2)):
        _close(r, o)
    loss = pwc.multiscale_epe_loss(params, t1, t2, tg)
    _close(loss_ref, loss)
    grads = torch.autograd.grad(loss, leaves)
    ref = _flat(grads_ref)
    for (k, _), g in zip(pwc._flatten(params), grads):
        _close(ref[k], to_hwio(g) if g.dim() == 4 else g)


def test_adam_step_matches_optax():
    params = pwc.init_pwc(prng.prng_key(3))
    start = _np(params)
    img1, img2, gt = (torch.from_numpy(a) for a in _batch())
    for t in pwc.leaves(params):
        t.requires_grad_(True)
    grads = torch.autograd.grad(pwc.multiscale_epe_loss(params, img1, img2, gt), pwc.leaves(params))
    opt = pwc.adam(1e-3)
    state = opt.init(params)
    with torch.no_grad():
        torch._foreach_add_(pwc.leaves(params), opt.update(list(grads), state, pwc.leaves(params)))
    by_key = {k: (to_hwio(g) if g.dim() == 4 else g).numpy()
              for (k, _), g in zip(pwc._flatten(params), grads)}
    grad_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(start),
        [by_key[jax.tree_util.keystr(k)] for k, _ in jax.tree_util.tree_flatten_with_path(start)[0]])
    jopt = optax.adam(1e-3)
    ref = jax.jit(lambda p, g: optax.apply_updates(p, jopt.update(g, jopt.init(p))[0]))(start, grad_tree)
    ref, out = _flat(ref), dict(pwc._flatten(_np(params)))
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-7)


def test_params_npz_read_by_both_packages(tmp_path):
    params = pwc.init_pwc(prng.prng_key(4))
    port_path = pwc.save_params(params, str(tmp_path / "port.npz"))
    with np.load(port_path) as f:
        port_keys = sorted(f.files)
    from_port = _flat(jpwc.load_params(port_path))
    assert port_keys == sorted(from_port)
    for k, v in pwc._flatten(_np(params)):
        np.testing.assert_array_equal(from_port[k], v)

    jax_tree = jax.tree_util.tree_map(lambda v: jnp.asarray(v) + 0.5, _np(params))
    jax_path = jpwc.save_params(jax_tree, str(tmp_path / "jax.npz"))
    with np.load(jax_path) as f:
        assert sorted(f.files) == port_keys
    loaded = pwc.load_params(jax_path)
    for k, v in pwc._flatten(loaded):
        np.testing.assert_array_equal(to_hwio(v).numpy() if v.dim() == 4 else v.numpy(),
                                      _flat(jax_tree)[k])


def _stub_fits(monkeypatch, losing=0):
    """``train_synthetic`` drawing init params from the fit's key and
    ``validate_fit`` calling the first ``losing`` fits worse than
    Horn-Schunck; returns the keys fitted."""
    keys = []

    def fit(key, device=None):
        keys.append(key)
        return pwc.init_pwc(key, device=device)

    def validate(params, device=None):
        ratio = 2.0 if len(keys) <= losing else 0.5
        return [("7px", ratio, 1.0, True), ("12px", ratio, 1.0, True), ("ceiling", 5.0, 1.0, False)]

    monkeypatch.setattr(pwc, "train_synthetic", fit)
    monkeypatch.setattr(pwc, "validate_fit", validate)
    return keys


def test_default_params_loads_else_fits_from_1234_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path))
    keys = _stub_fits(monkeypatch, losing=1)
    pwc.default_params.cache_clear()
    try:
        fitted = pwc.default_params("cpu")
        assert keys == [prng.prng_key(1234)] and not list(tmp_path.iterdir())
        assert pwc.default_params("cpu") is fitted
        path = pwc.save_params(pwc.init_pwc(prng.prng_key(3)))
        pwc.default_params.cache_clear()
        loaded = pwc.default_params("cpu")
        assert len(keys) == 1
        for a, b in zip(pwc.leaves(pwc.load_params(path)), pwc.leaves(loaded)):
            assert torch.equal(a, b)
    finally:
        pwc.default_params.cache_clear()


@pytest.mark.parametrize("losing", [0, 1, prepare.FIT_ATTEMPTS])
def test_fit_pwc_weights_fits_again_where_a_fit_loses_to_horn_schunck(tmp_path, monkeypatch, losing):
    """The CLI's fit: default_params' key first, then fold_in(key, 10000 +
    attempt) while validation fails; the passing fit is written, and where
    none passes, RuntimeError and no file."""
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path))
    keys = _stub_fits(monkeypatch, losing)
    root = prng.prng_key(1234)
    want = [root] + [prng.fold_in(root, 10_000 + a) for a in range(1, prepare.FIT_ATTEMPTS)]
    path = tmp_path / "pwc_lite.npz"
    if losing == prepare.FIT_ATTEMPTS:
        with pytest.raises(RuntimeError, match="none of"):
            prepare.fit_pwc_weights("cpu")
        assert keys == want and not path.exists()
        return
    assert prepare.fit_pwc_weights("cpu") == str(path)
    assert keys == want[:losing + 1]
    for a, b in zip(pwc.leaves(pwc.load_params(str(path))), pwc.leaves(pwc.init_pwc(keys[-1]))):
        assert torch.equal(a, b)
    assert prepare.fit_pwc_weights("cpu") == str(path) and len(keys) == losing + 1   # loaded, not fitted


def test_validate_fit_draws_no_guard_or_fit_pairs(monkeypatch):
    """validate_fit is regime_guards on 24 pairs per regime from
    PRNGKey(7), not from the guards' keys nor from the CLI's fit keys."""
    val = [prng.fold_in(prng.prng_key(7), r) for r in range(5)]
    root = prng.prng_key(1234)
    fits = [root] + [prng.fold_in(root, 10_000 + a) for a in range(1, prepare.FIT_ATTEMPTS)]
    assert not set(val) & ({prng.prng_key(k) for k in pwc.GUARD_KEYS} | set(fits))
    calls = []
    monkeypatch.setattr(pwc, "regime_guards", lambda *a: calls.append(a) or [])
    pwc.validate_fit("params", "cpu")
    assert calls == [("params", "cpu", val, 24)]


def test_reproducible_restores_the_callers_settings():
    import torch.utils.deterministic as det

    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32, det.fill_uninitialized_memory)
    with pwc.reproducible():
        assert torch.are_deterministic_algorithms_enabled() and torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.allow_tf32 and not det.fill_uninitialized_memory
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32, det.fill_uninitialized_memory) == before


@pytest.mark.parametrize("size", [(8, 8), (64, 48), (5, 1)])
def test_upsample_flow_matches_interpolate(size):
    """_upsample_flow's index_select resize (JAX's interpolation weights)
    against F.interpolate (align_corners=True), whose weights are rounded
    its own way: values and gradients within GEN_TOL * (1 + max|ref|)."""
    from ipoke_tpu_torch.nn.core import resize_bilinear_align_corners

    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 4, 3, 2)).astype(np.float32))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya, yb = pwc._upsample_flow(a, size), resize_bilinear_align_corners(b, size) * pwc._scale(size, b)
    torch.testing.assert_close(ya, yb, rtol=0, atol=GEN_TOL * (1 + float(yb.abs().max())))
    g = torch.from_numpy(np.random.default_rng(3).normal(size=ya.shape).astype(np.float32))
    ga, = torch.autograd.grad(ya, a, g)
    gb, = torch.autograd.grad(yb, b, g)
    torch.testing.assert_close(ga, gb, rtol=0, atol=GEN_TOL * (1 + float(gb.abs().max())))


@pytest.mark.slow
def test_train_synthetic_steps_match_jax():
    """Five fit steps.  Adam's first steps move a weight by ~lr * sign(g),
    so where a gradient lies within rounding of zero the two packages' signs
    may differ and the weight by up to 2 * lr per step (~1% of the entries
    of the coarse pyramid convs here): 99% of each leaf within
    1e-4 * (1 + max|ref|), all of it within 2 * lr * steps."""
    steps, lr = 5, 1e-3
    ref = _flat(jpwc.train_synthetic(jax.random.PRNGKey(6), steps=steps, batch=2, size=32, lr=lr))
    out = dict(pwc._flatten(_np(pwc.train_synthetic(prng.prng_key(6), steps=steps, batch=2, size=32,
                                                    lr=lr, device="cpu"))))
    for k in ref:
        err = np.abs(ref[k] - out[k])
        assert err.max() <= 2 * lr * steps, k
        assert np.mean(err <= TOL * (1 + np.abs(ref[k]).max())) >= 0.99, k


@pytest.mark.slow
def test_jax_default_fit_under_the_guards(tmp_path):
    """JAX's own fit from default_params' key (PRNGKey(1234)) on the CPU,
    under the guards (printed; run with -s): it beats Horn-Schunck in every
    regime, but misses the 12 px ceiling its test holds the key-0 fit to,
    which is why the prepare CLI's fit does not require the ceilings."""
    path = jpwc.save_params(jpwc.train_synthetic(jax.random.PRNGKey(1234)), str(tmp_path / "jax.npz"))
    guards = pwc.regime_guards(pwc.load_params(path), "cpu")
    print("\n".join(f"{c}: {v:.4f} < {lim:.4f}" for c, v, lim, _ in guards))
    against_hs = [g for g in guards if g[3]]
    assert len(against_hs) == 5 and all(v < lim for _, v, lim, _ in against_hs)


@pytest.mark.slow
def test_port_fit_passes_the_regime_guards():
    params = pwc.train_synthetic(prng.prng_key(0), device="cpu")
    failed = [g for g in pwc.regime_guards(params, "cpu") if not g[1] < g[2]]
    assert not failed, failed

