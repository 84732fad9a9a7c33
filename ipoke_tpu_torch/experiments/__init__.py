"""Experiment registry (the port's counterpart of
``ipoke_tpu/experiments/__init__.py``)."""
from __future__ import annotations

import importlib
from typing import Callable, NamedTuple

# general.experiment -> the port's module under ipoke_tpu_torch.experiments
MODULES = {"second_stage": "second_stage", "first_stage": "first_stage",
           "img_encoder": "encoders", "poke_encoder": "encoders", "distill": "distill"}


class Experiment(NamedTuple):
    """A run of a config: ``train(device=None, max_steps=None)`` and
    ``test(mode=None, device=None)``; only the second stage reads ``mode``
    (the other JAX experiments ignore it too)."""
    name: str
    train: Callable
    test: Callable


def select_experiment(config, dirs) -> Experiment:
    name = config["general"]["experiment"]
    if name not in MODULES:
        raise KeyError(f"unknown experiment {name}")
    mod = importlib.import_module(f"ipoke_tpu_torch.experiments.{MODULES[name]}")

    def train(device=None, max_steps=None):
        return mod.train(config, dirs, device=device, max_steps=max_steps)

    def test(mode=None, device=None):
        if name == "second_stage":
            return mod.test(config, dirs, mode=mode, device=device)
        return mod.test(config, dirs, device=device)

    return Experiment(name, train, test)
