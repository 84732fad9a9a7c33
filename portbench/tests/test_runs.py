"""Whole runs on the CPU at the tiny cells: a sound run is correct, a run
with its timed path broken underneath is not, a cell, configuration or
metric added as files is run with no code edited, and the entry point
refuses to run without a card."""
import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def _run(root, pkg, name, trace=False, seconds=0.3):
    return run.run_cell(name, SEED, seconds, trace, torch.device("cpu"), pkg=pkg, root=root)


@pytest.mark.parametrize("name", ["tiny.sample", "tiny.gan"])
def test_sound_run_is_correct(tiny, name):
    root, pkg = tiny
    line = _run(root, pkg, name)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2


def test_traced_run_reports_the_cells_per_layer_metrics(tiny):
    root, pkg = tiny
    line = _run(root, pkg, "tiny.sample", trace=True)
    assert line["correct"] is True
    assert {"mfu_pct.sample", "device_idle_pct.sample", "launches_per_video"} <= set(line["metrics"])
    assert "window_s" in line["device"] and "breakdown" in line


def _broken_sample(monkeypatch, fault):
    from ipoke_tpu_torch.models import second_stage
    real = second_stage.forward_sample

    def broken(params, spec, batch, z=None, **kw):
        if fault == "half_batch":     # the second half of the images left out, the first repeated
            b = batch["images"].shape[0] // 2
            half = {k: v[:b] for k, v in batch.items()}
            out = real(params, spec, half, z=z[:, :b], **kw)
            return torch.cat([out, out], dim=1)
        out = real(params, spec, batch, z=z, **kw).clone()
        # one pixel of one video altered where it is produced: off, or not a number
        out[0, 0, 0, 0, 0, 0] = float("nan") if fault == "nan" else out[0, 0, 0, 0, 0, 0] + 0.05
        return out

    monkeypatch.setattr(second_stage, "forward_sample", broken)


def _broken_gan(monkeypatch, fault):
    from ipoke_tpu_torch.train import first_stage as tfs
    real_make = tfs.make_gan_train_step

    def make(*a, **kw):
        real = real_make(*a, **kw)

        def step(state, batch, rng, on_phase=lambda name: None):
            if fault == "half_batch":   # the mean over half of the batch
                return real(state, {"images": batch["images"][: batch["images"].shape[0] // 2]},
                            rng, on_phase)
            saved = copy.deepcopy(state)  # a step that returns its state unchanged
            _, metrics = real(state, batch, rng, on_phase)
            with torch.no_grad():
                for a_, b_ in zip(_tensors(state), _tensors(saved)):
                    a_.copy_(b_)
            return state, metrics

        step.losses = real.losses
        return step

    monkeypatch.setattr(tfs, "make_gan_train_step", make)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@pytest.mark.parametrize("cell,fault", [("tiny.sample", "altered"), ("tiny.sample", "nan"),
                                        ("tiny.sample", "half_batch"),
                                        ("tiny.gan", "unchanged"), ("tiny.gan", "half_batch")])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    root, pkg = tiny
    (_broken_sample if cell == "tiny.sample" else _broken_gan)(monkeypatch, fault)
    line = _run(root, pkg, cell)
    assert line["correct"] is False and line["failed"] > 0


def test_cell_config_and_metric_added_as_files(tiny):
    root, pkg = tiny
    cfg = json.loads((pkg / "configs" / "tiny.json").read_text())
    cfg["name"] = "tiny_b"
    cfg["flow"]["num_steps"] = [2, 1]
    (pkg / "configs" / "tiny_b.json").write_text(json.dumps(cfg))
    cell = json.loads((pkg / "workloads" / "tiny.sample.json").read_text())
    cell["config"] = "tiny_b"
    (pkg / "workloads" / "tiny_b.sample.json").write_text(json.dumps(cell))
    (pkg / "metrics" / "calls_traced.py").write_text(
        "def read(r):\n    return float(r['units']) if r.get('kind') == 'sample' else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "device_trace", "layer": "sampling call",
                               "moves": "videos_per_s", "workloads": ["tiny_b.sample"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "tiny.sample" in m["workloads"]:
            m["workloads"].append("tiny_b.sample")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = _run(root, pkg, "tiny_b.sample", trace=True)
    assert line["correct"] is True and line["metrics"]["calls_traced"]["value"] == 1.0


def _entry(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "iper_128.sample.eval40", "--seed", str(SEED), "--seconds", "1"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_entry_point_exits_without_a_card():
    out = _entry(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_entry_point_exits_beside_the_benchmark_alone(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _entry(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "ipoke_tpu_torch" in out.stderr
