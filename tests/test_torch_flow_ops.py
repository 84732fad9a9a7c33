"""The port's flow ops (``ipoke_tpu_torch/ops/flow_ops.py``) against the JAX
package's on the CPU, on the same seeded numpy inputs:

* ``channel_norm`` and ``correlation_cost_volume`` (max_disp 4 and 2,
  stride 1 and 2): each displacement's channel, dy outer and dx inner;
* ``warp_bilinear`` with flows that leave the frame and land exactly on its
  last row and column, and its gradients in ``x`` and ``flow`` against
  ``jax.grad`` (``jnp.clip`` splits the gradient at a tie in halves);
* Horn-Schunck: one iteration on white noise, then ``horn_schunck_level``
  and ``estimate_flow`` at 32^2 with 3 levels and 10 iterations.

Tolerance 1e-5 * (1 + max|ref|) unless stated.  The Horn-Schunck iteration
divides by ``alpha^2 + |grad I|^2`` and warps by ``floor``, so on white
noise it amplifies XLA's fused multiply-adds (one rounding where torch
rounds twice, ~3e-7 after one iteration) about tenfold every few
iterations; the 10-iteration cases run on smooth textures, the input an
optical-flow estimator sees, where the paths stay within the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.ops import flow_ops as jfo
from ipoke_tpu_torch.nn.core import resize_bilinear_align_corners
from ipoke_tpu_torch.ops import flow_ops

TOL = 1e-5


def _close(ref, out, tol=TOL):
    ref, out = np.asarray(ref), out.detach().numpy()
    assert ref.shape == out.shape
    err = np.abs(ref - out).max()
    assert err <= tol * (1 + np.abs(ref).max()), f"max |diff| {err:.3g}"


def _smooth(rng, shape, grid=8):
    """tanh of Gaussian noise on a grid x grid lattice, bilinearly upsampled."""
    coarse = torch.from_numpy(rng.standard_normal((shape[0], grid, grid, shape[3])).astype(np.float32))
    return np.tanh(resize_bilinear_align_corners(coarse, shape[1:3]).numpy())


def test_channel_norm():
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 7)).astype(np.float32)
    _close(jfo.channel_norm(x), flow_ops.channel_norm(torch.from_numpy(x)))


@pytest.mark.parametrize("max_disp,stride", [(4, 1), (2, 1), (4, 2), (2, 2)])
def test_correlation_cost_volume(max_disp, stride):
    rng = np.random.default_rng(max_disp * 10 + stride)
    f1, f2 = (rng.standard_normal((2, 9, 11, 5)).astype(np.float32) for _ in range(2))
    ref = jfo.correlation_cost_volume(f1, f2, max_disp=max_disp, stride=stride)
    _close(ref, flow_ops.correlation_cost_volume(torch.from_numpy(f1), torch.from_numpy(f2),
                                                 max_disp=max_disp, stride=stride))


def _warp_inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 8, 10, 2)) * 6).astype(np.float32)   # many leave the frame
    flow[0, 2, 3] = [5.0, -3.0]    # lands on the last row (7) and the first column (0)
    flow[1, 1, 1] = [-1.0, 8.0]    # on the first row and the last column (9)
    flow[0, 4, 4] = [0.0, 0.0]
    return x, flow, rng.standard_normal((2, 8, 10, 3)).astype(np.float32)


def test_warp_bilinear_and_its_gradients():
    x, flow, g = _warp_inputs()
    _close(jfo.warp_bilinear(x, flow), flow_ops.warp_bilinear(torch.from_numpy(x), torch.from_numpy(flow)))
    gx, gf = jax.jit(jax.grad(lambda a, f: jnp.sum(jfo.warp_bilinear(a, f) * g), argnums=(0, 1)))(x, flow)
    tx, tf = torch.from_numpy(x).requires_grad_(), torch.from_numpy(flow).requires_grad_()
    (flow_ops.warp_bilinear(tx, tf) * torch.from_numpy(g)).sum().backward()
    _close(gx, tx.grad)
    _close(gf, tf.grad)
    # the ties: JAX's gradient there is half of what torch.clamp would pass
    for b, i, j in ((0, 2, 3), (1, 1, 1)):
        np.testing.assert_allclose(tf.grad[b, i, j].numpy(), np.asarray(gf)[b, i, j], rtol=1e-5, atol=1e-6)


def test_horn_schunck_one_iteration_on_noise():
    rng = np.random.default_rng(3)
    img1 = np.tanh(rng.standard_normal((2, 16, 16, 1))).astype(np.float32)
    img2 = np.roll(img1, 2, axis=2)
    flow = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    ref = jfo.horn_schunck_level(img1, img2, flow, n_iters=1)
    out = flow_ops.horn_schunck_level(*(torch.from_numpy(a) for a in (img1, img2, flow)), n_iters=1)
    _close(ref, out, tol=1e-6)


def test_horn_schunck_level():
    rng = np.random.default_rng(4)
    img1 = _smooth(rng, (2, 32, 32, 1))
    img2 = np.roll(img1, 2, axis=2)
    flow = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    ref = jfo.horn_schunck_level(img1, img2, flow, n_iters=10)
    _close(ref, flow_ops.horn_schunck_level(*(torch.from_numpy(a) for a in (img1, img2, flow)),
                                            n_iters=10))


def test_estimate_flow():
    rng = np.random.default_rng(5)
    img1 = _smooth(rng, (2, 32, 32, 3))
    img2 = np.roll(img1, (1, -2), axis=(1, 2))
    ref = jax.jit(lambda a, b: jfo.estimate_flow(a, b, n_levels=3, n_iters=10))(img1, img2)
    _close(ref, flow_ops.estimate_flow(torch.from_numpy(img1), torch.from_numpy(img2),
                                       n_levels=3, n_iters=10))
