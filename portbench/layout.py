"""Where the benchmark's pieces live, found by name: configurations, cells,
traffic mixes, drivers and per-layer metric readers."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def _json(path):
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    return json.loads(path.read_text())


def benchmark(root=ROOT):
    return _json(Path(root) / "BENCHMARK.json")


def config(name, pkg=PKG):
    return _json(Path(pkg) / "configs" / f"{name}.json")


def cell(name, pkg=PKG):
    return _json(Path(pkg) / "workloads" / f"{name}.json")


def traffic(name, pkg=PKG):
    return _json(Path(pkg) / "traffic" / f"{name}.json")


def _module(path, label):
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {label} {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{label}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind, pkg=PKG):
    """The module that runs traffic of ``kind``: ``run(ctx) -> Outcome``."""
    return _module(Path(pkg) / "drivers" / f"{kind}.py", "driver")


def metric(name, pkg=PKG):
    """The reader of per-layer metric ``name``: ``read(readings) -> float or None``."""
    return _module(Path(pkg) / "metrics" / f"{name}.py", "metric")


def applies(entry, cell_name):
    """Whether a metric of ``BENCHMARK.json`` is reported in ``cell_name``."""
    return "workloads" not in entry or cell_name in entry["workloads"]
