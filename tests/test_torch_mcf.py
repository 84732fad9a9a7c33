"""The modules of the port's two CUDA kernels against the JAX package.

K1 (``ops/cuda/mcf_inverse``) behind ``flows.mcf.inverse`` and K2
(``ops/cuda/mcf_unit_inverse``) behind ``flows.macow.macow_unit_inverse``.
On the CPU both wrappers take their plain PyTorch versions; they are held
against JAX's scan and against JAX's Pallas kernels in interpret mode, at the
tolerance of tests/test_pallas_mcf.py and tests/test_pallas_unit.py (2e-4).
The kernels themselves run in tests/test_torch_cuda.py, on the card only.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from ipoke_tpu.flows import macow as jmacow
from ipoke_tpu.flows import mcf as jmcf
from ipoke_tpu_torch.ckpt.jax_bridge import _convert
from ipoke_tpu_torch.flows import macow, mcf
from ipoke_tpu_torch.ops.cuda import mcf_inverse as k1
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse as k2
from torch_port_util import CPU, np_tree, port_flow_spec, set_wn_gains, t

TOL = 2e-4
B, S, C, HC = 2, 8, 8, 12


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("cond", [True, False])
@pytest.mark.parametrize("order", ["A", "B", "C", "D"])
def test_mcf_inverse_module(order, cond):
    kernel = (2, 3) if order in "AB" else (3, 2)
    p = jmcf.init_mcf(jax.random.PRNGKey(0), C, kernel, h_channels=HC if cond else None)
    p = set_wn_gains(p, 0.2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, S, C)).astype(np.float32)
    h = rng.standard_normal((B, S, S, HC)).astype(np.float32) if cond else None
    jh = None if h is None else jnp.asarray(h)
    y, _ = jmcf.forward(p, jnp.asarray(x), h=jh, order=order)
    y = np.asarray(y)
    ref_scan = jmcf.inverse(p, jnp.asarray(y), h=jh, order=order, backend="scan")
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = jmcf.inverse(p, jnp.asarray(y), h=jh, order=order, backend="pallas")

    pt = _convert(np_tree(p), CPU)
    th = None if h is None else t(h)
    y_port, _ = mcf.forward(pt, t(x), h=th, order=order)
    _close(y_port, y)
    for backend in ("scan", "cuda"):
        out = mcf.inverse(pt, t(y), h=th, order=order, backend=backend)
        _close(out, ref_scan)
        _close(out, ref_pallas)
        _close(out, x, 5e-4)      # round trip, tests/test_pallas_mcf.py's bound
    assert k1.mcf_inverse.launches == 0   # CPU tensors never launch


@pytest.mark.parametrize("order", ["A", "B", "C", "D"])
def test_mcf_inverse_cuda_takes_inputs_as_stored(order, monkeypatch):
    """Backend 'cuda' hands z, h and w_shift to K1 as they are: no flip,
    transpose or copy on the way to the kernel."""
    seen = {}

    def kernel(*args):
        seen["args"] = args
        return args[0]

    monkeypatch.setattr(mcf, "mcf_inverse", kernel)
    rng = np.random.default_rng(3)
    n = lambda *shape: t(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    w = n(4 * C, C, *((2, 3) if order in "AB" else (3, 2)))
    p = {"net": {"shift_conv": {"w": w},
                 "conv1x1": {"v": n(2 * C, 4 * C + HC, 1, 1), "g": n(2 * C), "b": n(2 * C)}}}
    z, h = n(B, S, S, C), n(B, S, S, HC)
    assert mcf.inverse(p, z, h, order=order, alpha=0.5, backend="cuda") is z
    args = seen["args"]
    assert args[0] is z and args[1] is h and args[2] is w and args[5:] == (order, 0.5, "elu")
    assert tuple(args[3].shape) == (2 * C, 4 * C + HC)


def test_mcf_inverse_rejects_an_unknown_order():
    z, w, w1, b1 = (t(np.zeros(s, np.float32)) for s in ((1, 4, 4, 2), (8, 2, 2, 3), (4, 8), (4,)))
    with pytest.raises(ValueError, match="order"):
        k1.mcf_inverse(z, None, w, w1, b1, "E")


@pytest.mark.parametrize("cond", [True, False])
def test_macow_unit_inverse_module(cond):
    hc = 12 if cond else 0
    jspec = jmacow.FlowSpec(num_steps=(1,), in_channels=8, hidden_channels=16, h_channels=hc, factor=4)
    p = set_wn_gains(jmacow.init_macow_unit(jax.random.PRNGKey(0), 8, jspec), 0.2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, hc)).astype(np.float32) if cond else None
    jh = None if h is None else jnp.asarray(h)
    y, _ = jmacow.macow_unit_forward(p, jnp.asarray(x), jh, jspec)
    ref_scan = jmacow.macow_unit_inverse(p, y, jh, jspec)
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = jmacow.macow_unit_inverse(p, y, jh, replace(jspec, mcf_backend="pallas_unit"))

    pt = _convert(np_tree(p), CPU)
    th = None if h is None else t(h)
    y_port, _ = macow.macow_unit_forward(pt, t(x), th, port_flow_spec(jspec))
    _close(y_port, y)
    for backend in ("scan", "cuda", "cuda_unit"):
        out = macow.macow_unit_inverse(pt, t(np.asarray(y)), th, port_flow_spec(jspec, mcf_backend=backend))
        _close(out, ref_scan)
        _close(out, ref_pallas)
        _close(out, x, 5e-4)
    assert k2.macow_unit_inverse.launches == 0
