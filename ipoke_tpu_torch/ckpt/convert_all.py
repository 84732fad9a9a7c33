"""One-command onboarding of the released reference checkpoints (the port's
copy of ``ipoke_tpu/ckpt/convert_all.py``):

    python -m ipoke_tpu_torch.ckpt.convert_all --datapath <root> [--models a,b]
        [--out <root>] [--weights-out <dir>] [--skip-backbones] [--no-verify]
        [--device cpu]

finds the 8 released models in a DATAPATH tree laid out like the reference's
logs/ directory (models/pretrained_models.py:1-128 registry,
experiments/experiment.py:107-143 best_k_models.yaml discovery) and converts

  * each second-stage Lightning checkpoint, with its embedded frozen first
    stage, poke embedder and conditioner (``first_stage_model.`` etc.),
    gaps filled from the separately released sub-model checkpoints, and
  * every metric backbone found (I3D, VGG16/19, LPIPS heads,
    pose_resnet-152, InceptionV3)

into the JAX package's npz layout (``ckpt/torch_import``), written where the
JAX package writes it: ``<out>/logs/second_stage/ckpt/<model>/0/
converted-from-torch.npz`` with a ``best_k_models.json`` mirror, so
``io.find_best``, every test mode, ``serve -c/-m`` and ``--resume`` of either
package find it.  Then two self-checks: the flow schema round trip through
export_flow -> convert_flow, and a finite ``forward_sample`` at B=1 on the
device (the CUDA card unless ``--device cpu``; the MCF inverses on kernel K2
there, the plain scan on the CPU).

The spec comes from the tree's saved config (logs/second_stage/config/<model>/
config.yaml, the reference's saved-config-wins protocol) when present, else
from the registry.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

from ipoke_tpu_torch import registry, resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt import torch_import as ti
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage
from ipoke_tpu_torch.ops.cuda import launches_since

# exact released checkpoint filenames (reference models/pretrained_models.py)
SUB_CKPTS = {
    "poke_encoder": {
        "iper_128": "epoch=17-lpips-val=0.298.ckpt",
        "h36m_128": "epoch=19-lpips-val=0.109.ckpt",
        "plants_128": "epoch=79-lpips-val=0.301.ckpt",
        "iper_64": "epoch=16-lpips-val=0.172.ckpt",
        "taichi_128": "epoch=31-lpips-val=0.314.ckpt",
        "taichi_64": "epoch=14-lpips-val=0.229.ckpt",
        "plants_64": "epoch=60-lpips-val=0.183.ckpt",
        "h36m_64": "epoch=16-lpips-val=0.073.ckpt",
    },
    "first_stage": {
        "plants_128": "epoch=17-FVD-val=65.191.ckpt",
        "h36m_128": "epoch=13-FVD-val=109.079.ckpt",
        "taichi_128": "epoch=10-FVD-val=157.258.ckpt",
        "plants_64": "epoch=18-FVD-val=61.761.ckpt",
        "h36m_64": "epoch=18-FVD-val=108.995.ckpt",
        "iper_64": "epoch=28-FVD-val=67.734.ckpt",
        "taichi_64": "epoch=20-FVD-val=113.079.ckpt",
        "iper_128": "epoch=17-FVD-val=61.491.ckpt",
    },
    "img_encoder": {
        "plants_128": "epoch=71-lpips-val=0.051.ckpt",
        "iper_128": "epoch=12-lpips-val=0.026.ckpt",
        "h36m_128": "epoch=13-lpips-val=0.067.ckpt",
        "taichi_128": "epoch=25-lpips-val=0.110.ckpt",
        "taichi_64": "epoch=19-lpips-val=0.006.ckpt",
    },
}

# metric-backbone torch files searched for under the datapath (recursively,
# by basename pattern) -> (converter, output npz name)
BACKBONES = [
    (r"i3d.*\.pth$|i3d.*\.pt$", "convert_i3d", "i3d_kinetics_rgb.npz"),
    (r"vgg16.*\.pth$", "convert_torchvision_vgg", "vgg16_features.npz"),
    (r"vgg19.*\.pth$", "convert_torchvision_vgg", "vgg19_features.npz"),
    (r"lpips.*\.pth$|.*lin.*lpips.*", "convert_lpips_lins", "lpips_vgg_lins.npz"),
    (r"pose_resnet.*\.pth$|pose.*152.*\.pth$", "convert_pose_resnet", "pose_resnet_152.npz"),
    (r"inception.*\.pth$", "convert_inception_v3", "inception_v3_fid.npz"),
]


def mcf_backend(device) -> str:
    """The MCF inverse of a device: kernel K2 on the card, the plain scan on
    the CPU."""
    return "cuda_unit" if resolve_device(device).type == "cuda" else "scan"


def _best_ckpt(ckpt_dir: str) -> Optional[str]:
    """Reference protocol (experiments/experiment.py:107-143): best entry of
    best_k_models.yaml (or .json) in the latest integer version dir, else
    last.ckpt, else the *.ckpt with the least metric in its file name."""
    if not os.path.isdir(ckpt_dir):
        return None
    versions = sorted((d for d in os.listdir(ckpt_dir)
                       if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))),
                      key=int, reverse=True)
    for v in versions + ([""] if not versions else []):
        vdir = os.path.join(ckpt_dir, v)
        for bk_name in ("best_k_models.yaml", "best_k_models.json"):
            bk = os.path.join(vdir, bk_name)
            if not os.path.exists(bk):
                continue
            try:
                with open(bk) as f:
                    if bk.endswith(".json"):
                        entries = json.load(f)
                    else:
                        import yaml

                        entries = yaml.safe_load(f)
                best = min(entries, key=entries.get) if entries else None
            except Exception as e:   # an unreadable list falls through to the next rule
                print(f"convert_all: {bk} unreadable ({e!r}); trying the next rule", flush=True)
                continue
            if best is not None:
                for cand in (io.datapath_rewrite(best), os.path.basename(best)):
                    if not os.path.isabs(cand):
                        cand = os.path.join(vdir, os.path.basename(cand))
                    if os.path.exists(cand):
                        return cand
        last = os.path.join(vdir, "last.ckpt")
        if os.path.exists(last):
            return last
        cands = sorted(glob.glob(os.path.join(vdir, "*.ckpt")))
        if cands:
            def metric_of(p):
                m = re.search(r"=(\d+(?:\.\d+)?)\.ckpt$", os.path.basename(p))
                return float(m.group(1)) if m else float("inf")

            return min(cands, key=metric_of)
    return None


def _spec_for(root: str, model: str, device=None):
    """The saved config's spec (logs/second_stage/config/<model>/config.yaml),
    else the registry's, with the MCF backend of ``device``."""
    backend = mcf_backend(device)
    cfg_path = os.path.join(root, "logs", "second_stage", "config", model, "config.yaml")
    if os.path.exists(cfg_path):
        import yaml

        from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config

        with open(cfg_path) as f:
            return build_spec_from_config(yaml.safe_load(f), mcf_backend=backend)
    return registry.build_specs(registry.MODELS[model], mcf_backend=backend)


def _load_sub(root: str, kind: str, model: str) -> Optional[Dict[str, np.ndarray]]:
    name = SUB_CKPTS.get(kind, {}).get(model)
    cdir = os.path.join(root, "logs", kind, "ckpt", model)
    path = os.path.join(cdir, "0", name) if name else None
    if not path or not os.path.exists(path):
        path = _best_ckpt(cdir)
    if path and os.path.exists(path):
        return ti.load_lightning_ckpt(path)
    return None


def convert_model(root: str, model: str, out_root: str, verify: bool = True, device=None):
    """Convert one released second-stage model (and its embedded towers),
    write the npz and its best_k_models.json mirror under ``out_root``, and
    with ``verify`` run the self-checks on ``device``.  ``seconds``: the
    host seconds of each part."""
    spec = _spec_for(root, model, device)
    ss_path = _best_ckpt(os.path.join(root, "logs", "second_stage", "ckpt", model))
    if ss_path is None:
        return {"model": model, "status": "missing", "searched": os.path.join(
            root, "logs", "second_stage", "ckpt", model)}
    seconds = {}
    t0 = time.perf_counter()
    sd = ti.load_lightning_ckpt(ss_path)
    subs = {key: _load_sub(root, kind, model) for key, kind in (
        ("first_stage_sd", "first_stage"), ("poke_sd", "poke_encoder"), ("cond_sd", "img_encoder"))}
    seconds["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = ti.convert_second_stage(sd, spec, **subs)
    del sd, subs
    seconds["convert"] = time.perf_counter() - t0
    result = {"model": model, "status": "converted", "source": ss_path}
    if verify:
        t0 = time.perf_counter()
        result.update(_self_check(params, spec, device))
        seconds["self_check"] = time.perf_counter() - t0
    out_dir = os.path.join(out_root, "logs", "second_stage", "ckpt", model, "0")
    out_path = os.path.join(out_dir, "converted-from-torch.npz")
    t0 = time.perf_counter()
    io.save(out_path, params, metadata={"source": ss_path, "model": model})
    with open(os.path.join(out_dir, "best_k_models.json"), "w") as f:
        json.dump({out_path: 0.0}, f)
    seconds["save"] = time.perf_counter() - t0
    result["out"] = out_path
    result["seconds"] = seconds
    return result


def _self_check(params, spec, device=None):
    """Cheap invariants after a conversion: the flow schema round trip
    export_flow -> convert_flow (catches key-mapping drift) and a finite
    sample at B=1 from zero images and a zero poke on ``device`` (catches
    shape and assembly errors).  ``launches``: the MCF kernels' launches of
    the sample."""
    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.utils import prng, profiling

    device = resolve_device(device)
    flat1 = dict(_flat(params["flow"]))
    flat2 = dict(_flat(ti.convert_flow(ti.export_flow(params["flow"], spec.flow), spec.flow)))
    max_err = max(float(np.max(np.abs(np.asarray(flat1[k]) - np.asarray(flat2[k]))))
                  for k in flat1)
    checks = {"flow_roundtrip_max_err": max_err, "flow_roundtrip_ok": bool(max_err < 1e-5)}
    s = spec.first_stage.spatial_size
    batch = {"images": torch.zeros((1, spec.first_stage.max_frames, s, s, 3), device=device),
             "poke": torch.zeros((1, s, s, 2), device=device)}
    before = profiling.counts()
    with torch.no_grad():
        vid = second_stage.forward_sample(bridge_second_stage(params, spec, device), spec, batch,
                                          prng.prng_key(0))
    checks["sample_finite"] = bool(torch.isfinite(vid).all())
    checks["launches"] = launches_since(before)
    return checks


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def convert_backbones(root: str, weights_out: str):
    """Find and convert every metric backbone torch file under the datapath."""
    results = {}
    all_files = [p for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                 if os.path.isfile(p)]
    for pattern, conv_name, out_name in BACKBONES:
        rx = re.compile(pattern, re.IGNORECASE)
        matches = [p for p in all_files if rx.search(os.path.basename(p))]
        if not matches:
            results[out_name] = {"status": "missing", "pattern": pattern}
            continue
        src = matches[0]
        try:
            raw = torch.load(src, map_location="cpu", weights_only=False)
            sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
            sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in sd.items()}
            getattr(ti, conv_name)(sd, os.path.join(weights_out, out_name))
            results[out_name] = {"status": "converted", "source": src}
        except Exception as e:   # one bad file is reported; the others still convert
            results[out_name] = {"status": f"error: {e!r}", "source": src}
    return results


def fvd_gate(model: str, config: dict, datamod, dirs, params=None, spec=None):
    """The FVD of a converted model (``params`` in the port's layout on its
    device) against the published reference number (BASELINE.md): pass =
    within 2%."""
    from ipoke_tpu_torch.eval import test_modes

    entry = registry.MODELS[model]
    out = test_modes.run_fvd(params, spec, config, datamod, dirs)
    score = out.get("FVD", out.get("FVD_UNPRETRAINED"))
    gate = None
    if entry.fvd_reference and "FVD" in out:
        gate = bool(score <= entry.fvd_reference * 1.02)
    return {"model": model, "fvd": score, "fvd_reference": entry.fvd_reference,
            "within_2pct": gate, "pretrained_i3d": out.get("i3d_pretrained")}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.ckpt.convert_all",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--datapath", required=True, help="root of the reference logs/ tree")
    ap.add_argument("--out", default=None,
                    help="output root for converted model trees (default: datapath)")
    ap.add_argument("--weights-out", default=None,
                    help="metric-backbone npz dir (default: $IPOKE_WEIGHTS or logs/weights)")
    ap.add_argument("--models", default=None,
                    help="comma-separated subset (default: all 8 released)")
    ap.add_argument("--skip-backbones", action="store_true")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the self-check (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    root = args.datapath
    out_root = args.out or root
    weights_out = args.weights_out or os.environ.get(
        "IPOKE_WEIGHTS", os.path.join("logs", "weights"))
    models = args.models.split(",") if args.models else list(registry.MODELS)
    report = {"models": [], "backbones": {}}
    for m in models:
        res = convert_model(root, m, out_root, verify=not args.no_verify, device=device)
        report["models"].append(res)
        print(json.dumps(res, default=str), flush=True)
    if not args.skip_backbones:
        report["backbones"] = convert_backbones(root, weights_out)
        print(json.dumps(report["backbones"], default=str), flush=True)
    rpt_path = os.path.join(out_root, "convert_all_report.json")
    os.makedirs(out_root, exist_ok=True)
    with open(rpt_path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"report: {rpt_path}", flush=True)
    return report


if __name__ == "__main__":
    main()
