"""The PyTorch port's package boundary and its NN primitives against the JAX
package on the CPU: the same seeded numpy inputs through ``ipoke_tpu.nn``
and ``ipoke_tpu_torch.nn``, at the tolerance of tests/test_torch_parity.py."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.nn import blocks as jblocks
from ipoke_tpu.nn import core as jcore
from ipoke_tpu_torch.ckpt.jax_bridge import _convert
from ipoke_tpu_torch.nn import blocks, core
from torch_port_util import CPU, hwio_to_oihw, np_tree, t

RTOL = ATOL = 2e-5
ROOT = Path(__file__).resolve().parents[1]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "ipoke_tpu"


def test_port_imports_nothing_of_jax_or_ipoke_tpu():
    files = sorted((ROOT / "ipoke_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []
    # the prefix alone must not count: ipoke_tpu_torch is allowed
    assert not _forbidden("ipoke_tpu_torch.nn.core") and _forbidden("ipoke_tpu.nn")
    assert _forbidden("jax.numpy") and _forbidden("ipoke_tpu")


def _rng(seed):
    return np.random.default_rng(seed)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, ((1, 0), (2, 1)))])
def test_conv2d(stride, padding):
    r = _rng(0)
    x = r.standard_normal((2, 9, 9, 5)).astype(np.float32)
    w = r.standard_normal((3, 3, 5, 4)).astype(np.float32)
    b = r.standard_normal(4).astype(np.float32)
    ref = jcore.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding)
    _close(core.conv2d(t(x), hwio_to_oihw(w), t(b), stride=stride, padding=padding), ref)


def test_conv_transpose2d():
    r = _rng(1)
    x = r.standard_normal((2, 8, 8, 5)).astype(np.float32)
    w = r.standard_normal((3, 3, 5, 4)).astype(np.float32)   # JAX HWIO, I=in O=out
    b = r.standard_normal(4).astype(np.float32)
    ref = jcore.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    port = core.conv_transpose2d(t(x), t(w.transpose(2, 3, 0, 1)), t(b))
    assert port.shape == (2, 16, 16, 4)
    _close(port, ref)


def test_norms_activations_resize_weight_norm():
    r = _rng(2)
    x = r.standard_normal((2, 6, 6, 32)).astype(np.float32)
    gamma, beta = r.standard_normal(32).astype(np.float32), r.standard_normal(32).astype(np.float32)
    _close(core.group_norm(t(x), t(gamma), t(beta), 16),
           jcore.group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 16))
    _close(core.instance_norm(t(x)), jcore.instance_norm(jnp.asarray(x)))
    for name in ("relu", "elu", "lrelu", "leaky_relu", "tanh", "sigmoid", "none"):
        _close(core.activation(name)(t(x)), jcore.activation(name)(jnp.asarray(x)))
    for size in ((16, 16), (3, 5), (6, 6)):
        _close(core.resize_bilinear_align_corners(t(x[..., :3]), size),
               jcore.resize_bilinear_align_corners(jnp.asarray(x[..., :3]), size))
    v = r.standard_normal((3, 3, 7, 5)).astype(np.float32)
    v[..., 0] = 0.0   # the 1e-12 floor of the norm
    g = r.standard_normal(5).astype(np.float32)
    ref = jcore.weight_norm_materialize(jnp.asarray(v), jnp.asarray(g))
    _close(core.weight_norm_materialize(hwio_to_oihw(v), t(g)),
           np.asarray(ref).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("case", ["down_group", "up_none", "same_in", "unfused"])
def test_res_block(case):
    c_in, c_out, norm, up, stride = {
        "down_group": (16, 32, "group", False, 2),
        "up_none": (32, 16, "none", True, 1),
        "same_in": (16, 16, "in", False, 1),
        "unfused": (16, 32, "group", False, 2),
    }[case]
    p = jblocks.init_res_block(jax.random.PRNGKey(3), c_in, c_out, norm=norm,
                               upsampling=up, stride=stride, snorm=True)
    p = jax.tree_util.tree_map(np.asarray, p)
    if case == "unfused":   # bias mismatch takes the separate-conv path
        del p["conv1"]["conv"]["b"]
    if norm == "group":
        for k in ("conv1", "conv2"):
            p[k]["norm"]["gamma"] = _rng(4).standard_normal(c_out).astype(np.float32)
    x = _rng(5).standard_normal((2, 8, 8, c_in)).astype(np.float32)
    ref = jblocks.res_block_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                  norm=norm, upsampling=up, stride=stride)
    pt = {k: _convert(v, CPU, transposed=up and k != "conv2") for k, v in p.items()}
    _close(blocks.res_block_apply(pt, t(x), norm=norm, upsampling=up, stride=stride), ref)
    if case != "unfused":
        assert blocks._fusable(pt, up) == ("res_conv" in pt)


def test_conv_blocks_norm_conv_and_spade():
    r = _rng(6)
    x = r.standard_normal((2, 8, 8, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    pc = jblocks.init_conv2d_block(key, 16, 16, 3, norm="group")
    _close(blocks.conv2d_block_apply(_convert(np_tree(pc), CPU), t(x), padding=1, norm="group"),
           jblocks.conv2d_block_apply(pc, jnp.asarray(x), padding=1, norm="group"))
    _close(blocks.convT2d_block_apply(_convert(np_tree(pc), CPU, transposed=True), t(x), norm="in"),
           jblocks.convT2d_block_apply(pc, jnp.asarray(x), norm="in"))
    pn = jblocks.init_norm_conv2d(key, 3, 16, 8)
    _close(blocks.norm_conv2d_apply(_convert(np_tree(pn), CPU), t(x), padding=1),
           jblocks.norm_conv2d_apply(pn, jnp.asarray(x), padding=1))
    ps = jblocks.init_spade(key, 16)
    frame = r.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jblocks.spade_apply(ps, jnp.asarray(x), jnp.asarray(frame))
    pst = _convert(np_tree(ps), CPU)
    _close(blocks.spade_apply(pst, t(x), t(frame)), ref)
    mod = blocks.spade_modulation(pst, t(frame), (8, 8))
    _close(blocks.spade_apply(pst, t(x), None, shared_mod=mod), ref)
    assert [blocks.spade_num_groups(n) for n in (64, 24, 7)] == \
        [jblocks.spade_num_groups(n) for n in (64, 24, 7)]
