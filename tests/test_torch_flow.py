"""The port's multiscale MaCow flow against the JAX package on the CPU:
params drawn from JAX's keys by the port's ``init`` in JAX's layout and
carried back by ``ckpt/jax_bridge``, the same numpy inputs, at the
tolerance of the kernel tests (2e-4); the golden flow also at
tests/test_golden.py's pinned outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_golden
from ipoke_tpu.flows import transformer as jtransformer
from ipoke_tpu.flows.macow import FlowSpec
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_flow, unbridge_flow
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, np_tree, port_flow_spec, set_wn_gains, t

TOL = 2e-4


def _close(port, ref, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _port_drawn(jspec, seed, gain):
    """JAX-layout flow params drawn from JAX's key ``seed`` by the port's
    ``init`` (JAX's numbers within 7.2e-7, tests/test_torch_init.py; JAX's
    own eager init of them takes ~8 s here), weight-norm gains set to ``gain``."""
    return set_wn_gains(jax.tree_util.tree_map(jnp.asarray, unbridge_flow(
        transformer.init(prng.prng_key(seed), port_flow_spec(jspec), CPU))), gain)


@pytest.fixture(scope="module")
def golden():
    """tests/test_golden.py's flow (its spec, key 42, gains 0.1), its pinned
    inputs and JAX's reverse, computed once for both backends."""
    data = np.load(test_golden.GOLDEN)
    jspec = FlowSpec(num_steps=(2, 1), in_channels=8, hidden_channels=32, h_channels=12, factor=4)
    p = _port_drawn(jspec, 42, 0.1)
    ref = jtransformer.reverse(p, jspec, jnp.asarray(data["y"]), jnp.asarray(data["h"]))
    return data, p, jspec, ref


@pytest.mark.parametrize("backend", ["scan", "cuda_unit"])
def test_golden_flow(golden, backend):
    data, p, jspec, ref = golden
    pt = bridge_flow(np_tree(p), device=CPU)
    spec = port_flow_spec(jspec, mcf_backend=backend)
    x = transformer.reverse(pt, spec, t(data["y"]), t(data["h"]))
    _close(x, ref)
    # round trip to the pinned input, at tests/test_golden.py's bound
    _close(x, data["x"], 2e-3, 2e-3)
    y, ld = transformer.forward(pt, spec, t(data["x"]), t(data["h"]))
    _close(y, data["y"], 2e-4, 2e-5)
    _close(ld, data["logdet"], 2e-4, 0)


def test_registry_shaped_topology():
    """Three levels peeling 2 channels each, with the registry's kernel,
    splits and conditioning layout at narrow widths."""
    jspec = FlowSpec(num_steps=(2, 1, 1), in_channels=12, hidden_channels=16,
                     h_channels=12, factor=6)
    p = _port_drawn(jspec, 3, 0.1)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    ref = jtransformer.reverse(p, jspec, jnp.asarray(z), jnp.asarray(h))
    pt = bridge_flow(np_tree(p), device=CPU)
    for backend in ("cuda_unit", "cuda"):
        _close(transformer.reverse(pt, port_flow_spec(jspec, mcf_backend=backend), t(z), t(h)), ref)
    assert transformer.reverse_input_shape(port_flow_spec(jspec), 2, 8, 12) == \
        jtransformer.reverse_input_shape(jspec, 2, 8, 12)
