"""The port's one-command onboarding (``ipoke_tpu_torch/ckpt/convert_all.py``)
and quality gate (``ipoke_tpu_torch/ckpt/quality_gate.py``) on a fabricated
DATAPATH tree laid out as the JAX package's tests/test_convert_all.py lays
it out: a Lightning .ckpt of a tiny second stage in the reference's key
schema (spectral-norm convs as torch stores them), best_k_models.yaml, the
saved config.yaml and a pip-lpips .pth.  The npz the port writes is held to
the JAX package's ``convert_model(..., verify=False)`` leaf for leaf; the
gate's verdicts and exit codes mirror tests/test_quality_gate.py, with
stand-in FVD features (I3D's are held to JAX's in test_torch_metrics.py)."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu.ckpt import convert_all as jconvert_all
from ipoke_tpu.ckpt import io as jio
from ipoke_tpu_torch.ckpt import convert_all, io, quality_gate
from ipoke_tpu_torch.ckpt import torch_import as ti
from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
from ipoke_tpu_torch.metrics import fvd as fvd_mod
from ipoke_tpu_torch.metrics import i3d
from torch_ckpt_fixture import reference_tree
from torch_port_util import assert_trees_equal, np_tree, tiny_config

MODEL = "iper_128"   # a registry name; the saved config sets the tiny architecture


def fake_tree(root):
    """The reference's logs/ layout under ``root`` holding one tiny model."""
    cfg = tiny_config(root)
    cfg["general"] = {"model_name": MODEL}
    spec = build_spec_from_config(cfg, mcf_backend="scan")
    ck_dir = os.path.join(root, "logs", "second_stage", "ckpt", MODEL, "0")
    os.makedirs(ck_dir)
    ck_path = os.path.join(ck_dir, "epoch=3-FVD-val=80.000.ckpt")
    sd = ti.export_second_stage(reference_tree(spec, seed=7), spec)
    torch.save({"epoch": 3, "global_step": 1200, "pytorch-lightning_version": "1.1.7",
                "state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "optimizer_states": [], "lr_schedulers": [],
                "hyper_parameters": {"model_name": MODEL}}, ck_path)
    with open(os.path.join(ck_dir, "best_k_models.yaml"), "w") as f:
        yaml.safe_dump({ck_path: 80.0}, f)
    cfg_dir = os.path.join(root, "logs", "second_stage", "config", MODEL)
    os.makedirs(cfg_dir)
    with open(os.path.join(cfg_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    lins = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
            for i, c in enumerate((64, 128, 256, 512, 512))}
    os.makedirs(os.path.join(root, "weights_src"))
    torch.save(lins, os.path.join(root, "weights_src", "lpips_vgg_lins.pth"))
    return ck_path


@pytest.fixture(scope="module")
def datapath(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datapath"))
    fake_tree(root)
    return root


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_convert_all_matches_jax(tmp_path):
    root = str(tmp_path / "datapath")
    os.makedirs(root)
    fake_tree(root)
    wdir = str(tmp_path / "weights")
    report = convert_all.main(["--datapath", root, "--models", MODEL, "--weights-out", wdir,
                               "--device", "cpu"])
    (res,) = report["models"]
    assert res["status"] == "converted", res
    assert res["flow_roundtrip_ok"] and res["sample_finite"], res
    assert res["launches"] == {"mcf_inverse": 0, "macow_unit_inverse": 0}   # the plain scan
    assert os.path.exists(os.path.join(root, "convert_all_report.json"))
    # the found backbone converted, the absent ones reported missing
    assert report["backbones"]["lpips_vgg_lins.npz"]["status"] == "converted"
    assert os.path.exists(os.path.join(wdir, "lpips_vgg_lins.npz"))
    assert report["backbones"]["i3d_kinetics_rgb.npz"]["status"] == "missing"

    theirs = jconvert_all.convert_model(root, MODEL, str(tmp_path / "jax_out"), verify=False)
    ours, ref = _npz(res["out"]), _npz(theirs["out"])
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    # JAX's io.load reads the port's file; find_best finds it through the mirror
    tree, meta = jio.load(res["out"])
    assert meta["model"] == MODEL
    assert_trees_equal(io.load(res["out"])[0], np_tree(tree))
    assert io.find_best(os.path.dirname(res["out"])) == res["out"]


def test_convert_all_missing_model(tmp_path):
    res = convert_all.convert_model(str(tmp_path), "plants_64", str(tmp_path), device="cpu")
    assert res["status"] == "missing"


# ---------------------------------------------------------------------------
# the quality gate
# ---------------------------------------------------------------------------

def _stand_in(videos):
    """Cheap deterministic 32-dim features per video in place of I3D's."""
    flat = videos.float().reshape(videos.shape[0], -1)
    return flat[:, ::max(1, flat.shape[1] // 32)][:, :32].cpu().numpy()


@pytest.fixture
def gate_env(tmp_path, monkeypatch):
    """No weights anywhere (the I3D is the seeded one), stand-in features."""
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path / "no_weights"))
    monkeypatch.delenv("DATAPATH", raising=False)
    monkeypatch.setattr(fvd_mod, "_features", _stand_in)
    for c in (i3d.load_params, i3d.i3d):
        c.cache_clear()
    yield tmp_path
    for c in (i3d.load_params, i3d.i3d):
        c.cache_clear()


def test_mount_detect(datapath, tmp_path, monkeypatch):
    monkeypatch.delenv("DATAPATH", raising=False)
    monkeypatch.setattr(quality_gate, "CANDIDATE_MOUNTS", (str(tmp_path / "nope"),))
    report, rc = quality_gate.run(datapath=str(tmp_path / "also_nope"), device="cpu")
    assert rc == 0 and "no reference checkpoint tree" in report["status"]
    monkeypatch.setenv("DATAPATH", datapath)
    assert quality_gate.detect_datapath(None) == datapath
    assert quality_gate.detect_models(datapath) == [MODEL]


def _gate(datapath, out, report, *extra):
    rc = quality_gate.main(["--datapath", datapath, "--out", str(out), "--models", MODEL,
                            "--n-samples-fvd", "8", "--batch", "4", "--skip-backbones",
                            "--report", str(report), "--device", "cpu", *extra])
    with open(report) as f:
        return rc, json.load(f)


@pytest.mark.parametrize("published,verdict,want_rc", [
    (None, "blocked", 0), (1e9, "pass", 0), (1e-9, "fail", 1)])
def test_quality_gate_verdicts(datapath, gate_env, published, verdict, want_rc):
    """Default honesty (unpretrained I3D, synthetic data: blocked, rc 0);
    with --allow-blocked-gates an anchor far above the score passes (rc 0)
    and one far below fails (rc 1), each with its gate_note."""
    extra = [] if published is None else [
        "--allow-blocked-gates", "--published", json.dumps({MODEL: published})]
    rc, rpt = _gate(datapath, gate_env / "out", gate_env / "r.json", *extra)
    assert rc == want_rc and rpt["status"] == ("fail" if want_rc else "pass")
    (conv,) = rpt["models"]
    assert conv["flow_roundtrip_ok"] and conv["sample_finite"]
    (gate,) = rpt["gates"]
    assert gate["fvd_key"] == "FVD_UNPRETRAINED" and gate["n_videos"] == 8
    assert np.isfinite(gate["fvd"]) and gate["fvd"] > 0
    assert gate["launches"] == {"mcf_inverse": 0, "macow_unit_inverse": 0}
    if verdict == "blocked":
        assert gate["gate"].startswith("blocked:") and "unpretrained I3D" in gate["gate"]
        assert "synthetic data" in gate["gate"] and "within_2pct" not in gate
    else:
        assert gate["gate"] == verdict and gate["within_2pct"] is (verdict == "pass")
        assert "NOT a quality claim" in gate["gate_note"]


def test_quality_gate_unknown_model(datapath, gate_env):
    report, rc = quality_gate.run(datapath=datapath, models=["iper_1288"], out_root=str(gate_env),
                                  skip_fvd=True, skip_backbones=True, device="cpu")
    assert report["unknown_models"] == ["iper_1288"] and rc == 0
    assert report["models_found"] == [MODEL]   # nothing known was named: every model found
