"""Stage-2 training of the flow variants through ``experiments/second_stage.
train`` on the CPU, the port alone: configs/debug_second_stage.yaml with
``augmented_input``, ``condition_nice`` and ``use1x1`` on, and with a
``multistack`` flow, 2 steps each; ``last.npz`` reloads to the trained
params, and a validation of the augmented run raises where JAX's fails (it
calls ``forward_density`` without a key)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage
from ipoke_tpu_torch.config import load_parameters
from ipoke_tpu_torch.data.datamodule import StaticDataModule
from ipoke_tpu_torch.experiments import second_stage as experiment
from ipoke_tpu_torch.flows.multistack import StackSpec
from torch_port_util import CPU, flatten

ROOT = Path(__file__).resolve().parents[1]
ARCH = {
    "augmented": dict(augmented_input=True, augment_channels=4, scale_augmentation=True,
                      shift_augmentation=True, condition_nice=True, use1x1=True),
    "multistack": dict(multistack=True, levels=[[1], [1]], factors=[16, 16], reshape="down"),
}


@pytest.mark.parametrize("variant", sorted(ARCH))
def test_variant_trains_two_steps(variant, tmp_path):
    cfg, dirs = load_parameters(str(ROOT / "configs" / "debug_second_stage.yaml"), variant,
                                base_dir=str(tmp_path))
    cfg["architecture"].update(ARCH[variant])
    run = experiment.train(cfg, dirs, device="cpu", max_steps=2)
    spec, params = run["spec"], run["state"].params
    assert isinstance(spec.flow, StackSpec) == (variant == "multistack")
    assert run["state"].step == 2
    assert all(np.isfinite(h["flow_loss"]) and np.isfinite(h["grad_norm"]) for h in run["history"])
    tree, meta = io.load(run["ckpt"])
    assert meta == {"step": 2}
    saved = flatten(bridge_second_stage(tree["params"], spec, device=CPU))
    trained = flatten(params)
    assert set(saved) == set(trained)
    for k, v in saved.items():
        assert torch.equal(v, trained[k]), k
    if variant == "augmented":
        assert sorted(params) == ["flow", "scale_augment", "shift_augment"]
        assert not torch.equal(params["scale_augment"], torch.ones(4))   # it trained
        datamod = StaticDataModule(cfg["data"])
        with pytest.raises(ValueError, match="JAX key"):
            experiment.validate({**run["frozen"], **params}, spec, cfg, datamod)
