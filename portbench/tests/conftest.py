"""CPU fixtures of the benchmark's tests: a copy of the benchmark beside a
tiny configuration, traffic and cell of each kind, so that a whole run can
be driven on the CPU in seconds.

    python -m pytest portbench/tests -q
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "portbench"


def tiny_files(root):
    """Write a copy of the benchmark under ``root`` with the tiny cells
    ``tiny.sample`` and ``tiny.gan`` (32x32 frames, a 2-level flow of one
    MaCowStep each at C=8) and a ``BENCHMARK.json`` naming them."""
    pkg = root / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((PKG / "configs" / "iper_128.json").read_text())
    cfg.update(name="tiny", frames=4, spatial_size=32)
    cfg["first_stage"].update(z_dim=8, spatial_size=32, max_frames=4, min_spatial_size=4,
                              enc_channels=[64, 128, 256, 256], dec_channels=[256, 256, 128, 64])
    cfg["flow"].update(num_steps=[1, 1], factor=4, flow_mid_channels_factor=4)
    cfg["poke_embedder"]["nf_max"] = cfg["conditioner"]["nf_max"] = 16
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    s = json.loads((PKG / "traffic" / "sample.eval40.json").read_text())
    s.update(start_images=2, n_samples=2, frames=4, warmup_calls=1, trace_calls=1, check_calls=1)
    (pkg / "traffic" / "tiny.sample.json").write_text(json.dumps(s))
    g = json.loads((PKG / "traffic" / "train.gan.json").read_text())
    g.update(batch=2, frames=4, mf_dt=4, n_spatial=4, trace_steps=1)
    (pkg / "traffic" / "tiny.gan.json").write_text(json.dumps(g))
    for cell, like, traffic in (("tiny.sample", "iper_128.sample.eval40", "tiny.sample"),
                                ("tiny.gan", "iper_128.train.gan", "tiny.gan")):
        c = json.loads((PKG / "workloads" / f"{like}.json").read_text())
        c.update(config="tiny", traffic=traffic)
        (pkg / "workloads" / f"{cell}.json").write_text(json.dumps(c))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({"tiny.sample" if ".sample." in w else "tiny.gan"
                                     for w in m["workloads"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return pkg


@pytest.fixture
def tiny(tmp_path):
    """(root, pkg) of a benchmark copy with the tiny cells."""
    return tmp_path, tiny_files(tmp_path)


@pytest.fixture(autouse=True)
def _plain_cpu():
    """oneDNN off: the port's and the reference's CPU convs then take the
    same kernels, whatever the host's instruction set."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield
