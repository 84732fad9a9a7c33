"""The port's multiscale MaCow flow against the JAX package on the CPU:
params built by JAX and carried across by ``ckpt/jax_bridge``, the same
numpy inputs, at the tolerance of the kernel tests (2e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_golden
from ipoke_tpu.flows import transformer as jtransformer
from ipoke_tpu.flows.macow import FlowSpec, init_multiscale
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_flow
from ipoke_tpu_torch.flows import transformer
from torch_port_util import CPU, np_tree, port_flow_spec, set_wn_gains, t

TOL = 2e-4


def _close(port, ref, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("backend", ["scan", "cuda_unit"])
def test_golden_flow(backend):
    data = np.load(test_golden.GOLDEN)
    p, jspec = test_golden._params()
    pt = bridge_flow(np_tree(p), device=CPU)
    spec = port_flow_spec(jspec, mcf_backend=backend)
    ref = jtransformer.reverse(p, jspec, jnp.asarray(data["y"]), jnp.asarray(data["h"]))
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
    p = set_wn_gains(init_multiscale(jax.random.PRNGKey(3), jspec), 0.1)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    h = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    ref = jtransformer.reverse(p, jspec, jnp.asarray(z), jnp.asarray(h))
    pt = bridge_flow(np_tree(p), device=CPU)
    for backend in ("cuda_unit", "cuda"):
        _close(transformer.reverse(pt, port_flow_spec(jspec, mcf_backend=backend), t(z), t(h)), ref)
    assert transformer.reverse_input_shape(port_flow_spec(jspec), 2, 8, 12) == \
        jtransformer.reverse_input_shape(jspec, 2, 8, 12)
