"""The port's ``init`` against the JAX package's on the CPU: the same seed
gives JAX's tree (through ``ckpt/jax_bridge``) leaf for leaf, permutations
bitwise, float leaves within 1e-6·(1+|ref|) (``prng.normal`` lies within
7.2e-7 of JAX's draw, and JAX's own eager and jitted inits differ by ~1 ulp),
the QR of the orthogonal ConvGRU gates within 1e-5; and ``-c/-m`` serving
fills a component that no checkpoint holds as JAX's ``_load_for_test`` does.
The spec is the tiny config of tests/test_torch_serve.py; JAX's eager init
compiles its random draws once per process (~40 s here), later seeds reuse them."""
import os

import jax
import numpy as np
import pytest
import torch

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.experiments.second_stage import SecondStageExperiment
from ipoke_tpu.experiments.second_stage import build_spec_from_config as jax_build_spec
from ipoke_tpu.models import second_stage as jss
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage, unbridge_second_stage
from ipoke_tpu_torch.config import load_parameters, save_yaml
from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config, load_for_serving
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.utils import prng
from torch_port_util import CPU, flatten, np_tree, tiny_config

FLOAT_TOL = 1e-6
ORTHOGONAL_TOL = 1e-5
SEEDS = [0, 7, 2**32 - 1]


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    cfg = tiny_config(tmp_path_factory.mktemp("init") / "logs")
    return cfg, jax_build_spec(cfg), build_spec_from_config(cfg)


def assert_tree_equal(got, want):
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def assert_tree_close(got, want):
    """Leaf for leaf: integer leaves bitwise, float leaves within FLOAT_TOL
    (the orthogonal ConvGRU gates within ORTHOGONAL_TOL)."""
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if not g.is_floating_point():
            assert torch.equal(g, w), k
            continue
        tol = ORTHOGONAL_TOL if "/rnn/" in k else FLOAT_TOL
        err = ((g - w).abs() / (1 + w.abs())).max().item()
        assert err <= tol, (k, err)


@pytest.mark.parametrize("seed", SEEDS)
def test_init_matches_jax(specs, seed):
    _, jspec, spec = specs
    want = bridge_second_stage(np_tree(jss.init(jax.random.PRNGKey(np.uint32(seed)), jspec)),
                               spec, device=CPU)
    got = second_stage.init(prng.prng_key(seed), spec, device=CPU)
    assert_tree_close(got, want)
    perm = got["flow"]["levels"][0]["steps"][0]["conv1x1"]
    assert sorted(perm["fwd_idx"].tolist()) == list(range(16))
    assert torch.equal(perm["fwd_idx"][perm["inv_idx"]], torch.arange(16))


def test_init_of_some_components_draws_their_keys(specs):
    _, _, spec = specs
    key = prng.prng_key(3)
    full = second_stage.init(key, spec, device=CPU)
    part = second_stage.init(key, spec, device=CPU, only=["conditioner", "flow"])
    assert sorted(part) == ["conditioner", "flow"]
    assert_tree_equal(part, {k: full[k] for k in part})
    if not torch.cuda.is_available():   # no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            second_stage.init(key, spec)


def test_load_for_serving_fills_as_jax(specs, tmp_path):
    """The first stage from its config ckpt, the flow from the run's best
    checkpoint (written by the port's ``ckpt/io``), the towers from fresh
    init at the config's seed: the port's load_for_serving against the bridge
    of JAX's ``_load_for_test``, which reads the port's checkpoint."""
    _, jspec, spec = specs
    p = jss.init(jax.random.PRNGKey(11), jspec)
    fs_path = str(tmp_path / "first_stage.npz")
    jio.save(fs_path, p["first_stage"])
    cfg = tiny_config(tmp_path / "logs", {"first_stage": fs_path}, seed=5)
    flow = bridge_second_stage({"flow": np_tree(p["flow"])}, spec, device=CPU)
    io.save(str(tmp_path / "logs" / "serve_ckpt" / "ckpt" / "m" / "0" / "FVD-val=3.5.npz"),
            {"step": np.int32(2), "params": unbridge_second_stage(flow, spec)})
    cfg_path = str(tmp_path / "second_stage.yaml")
    save_yaml(cfg, cfg_path)
    run_cfg, dirs = load_parameters(cfg_path, "m", test_mode="samples")
    got, spec = load_for_serving(run_cfg, dirs, device=CPU)
    want = SecondStageExperiment(run_cfg, dirs)._load_for_test()
    assert_tree_close(got, bridge_second_stage(np_tree(want), spec, device=CPU))
    # the loaded components bitwise, the filled ones from seed 5, not 11
    loaded = bridge_second_stage(np_tree(p), spec, device=CPU)
    assert_tree_equal({k: got[k] for k in ("flow", "first_stage")},
                      {k: loaded[k] for k in ("flow", "first_stage")})
    assert not torch.equal(got["conditioner"]["encoder"]["stem"]["conv"]["w"],
                           loaded["conditioner"]["encoder"]["stem"]["conv"]["w"])
    assert os.path.isdir(dirs["ckpt"])
