"""The quality gate (the port's copy of ``ipoke_tpu/ckpt/quality_gate.py``):
the one command to run when the released weights are at hand.

    python -m ipoke_tpu_torch.ckpt.quality_gate --datapath <root> [--models a,b]
        [--out <root>] [--weights-out <dir>] [--n-samples-fvd N] [--batch B]
        [--published overrides.json] [--allow-blocked-gates] [--skip-fvd]
        [--skip-backbones] [--report report.json] [--device cpu]

1. **mount-detect**: locate the reference ``logs/`` tree (``--datapath``,
   ``$DATAPATH``, or common mount points) and list which of the 8 released
   models (reference models/pretrained_models.py:1-128) have checkpoints.
2. **convert**: ``ckpt/convert_all`` per found model (and every metric
   backbone found under the root), with its self-checks: the flow schema
   round trip and a finite sample on the device.
3. **FVD gate**: the streaming FVD eval (``eval/test_modes.run_fvd``, the
   reference's --test fvd protocol, experiments/second_stage_video.py:
   188-200) per converted model, sampled on the device (kernel K2 on the
   card), against the published number (registry ``fvd_reference`` =
   README.md:57-64); pass = score <= published * 1.02.

Honesty gates: without real I3D weights the score's key is FVD_UNPRETRAINED
and the gate reads ``blocked: unpretrained I3D``; without a mounted dataset
the eval runs on the synthetic dataset and the gate reads ``blocked:
synthetic data``.  ``--allow-blocked-gates`` computes pass/fail all the same
with a ``gate_note`` (the tests' way to exercise both outcomes with
fabricated "published" numbers; never a quality claim).

Exit code: 0 when every converted model passes (or is blocked by the
environment); 1 on any conversion error or computed gate failure.  Runs on
the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

from ipoke_tpu_torch import registry, resolve_device
from ipoke_tpu_torch.ckpt import convert_all, io
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage

# common mount points of the data tree (``~``: the user's home)
CANDIDATE_MOUNTS = ("~/data", "/mnt/data", "/data", "~/ipoke_data")


def detect_datapath(datapath: Optional[str] = None) -> Optional[str]:
    """The reference logs/ tree's root: the explicit flag, $DATAPATH, or the
    first candidate mount that holds logs/second_stage/ckpt."""
    mounts = [os.path.expanduser(m) for m in CANDIDATE_MOUNTS]
    for c in (datapath, os.environ.get("DATAPATH"), *mounts):
        if c and os.path.isdir(os.path.join(c, "logs", "second_stage", "ckpt")):
            return c
    return None


def detect_models(root: str):
    """The released models with a discoverable second-stage checkpoint."""
    return [name for name in registry.MODELS if convert_all._best_ckpt(
        os.path.join(root, "logs", "second_stage", "ckpt", name))]


def _data_config(root: str, model: str, spec, n_samples_fvd: int, batch: int):
    """The FVD eval's data config: the model's saved training config's data
    section when its meta tree is mounted, else the synthetic dataset
    (flagged) at the converted model's geometry (the spec, not the registry:
    saved configs win)."""
    cfg_path = os.path.join(root, "logs", "second_stage", "config", model, "config.yaml")
    data_cfg, synthetic = None, True
    if os.path.exists(cfg_path):
        import yaml

        with open(cfg_path) as f:
            saved = yaml.safe_load(f)
        dc = dict(saved.get("data", {}))
        meta = dc.get("meta_path")
        if meta and os.path.exists(io.datapath_rewrite(meta)):
            dc["meta_path"] = io.datapath_rewrite(meta)
            data_cfg, synthetic = dc, False
    if data_cfg is None:
        s = spec.first_stage.spatial_size
        data_cfg = {
            "dataset": "SyntheticDataset",
            "spatial_size": [s, s],
            "max_frames": spec.first_stage.max_frames,
            "n_examples": max(batch, min(64, n_samples_fvd)),
        }
    data_cfg.setdefault("batch_size", batch)
    return data_cfg, synthetic


def gate_model(root: str, model: str, converted_npz: str, *,
               n_samples_fvd: int, batch: int = 16,
               published: Optional[float] = None,
               allow_blocked: bool = False, out_root: str = ".", device=None):
    """The FVD gate of one converted model on ``device``: the score, the
    published anchor and the verdict; ``launches``: the MCF kernels' launches
    of its sampling; ``seconds``: load and FVD host seconds."""
    from ipoke_tpu_torch.data.datamodule import StaticDataModule
    from ipoke_tpu_torch.eval import test_modes

    entry = registry.MODELS[model]
    anchor = published if published is not None else entry.fvd_reference
    spec = convert_all._spec_for(root, model, device)
    t0 = time.perf_counter()
    params = bridge_second_stage(converted_npz, spec, device)
    load_s = time.perf_counter() - t0
    data_cfg, synthetic = _data_config(root, model, spec, n_samples_fvd, batch)
    config = {"data": data_cfg, "testing": {"n_samples_fvd": n_samples_fvd, "save_fvd_npy": False}}
    gen_dir = os.path.join(out_root, "logs", "second_stage", "generated", model)
    os.makedirs(gen_dir, exist_ok=True)
    t0 = time.perf_counter()
    before = convert_all.launch_counts()
    out = test_modes.run_fvd(params, spec, config, StaticDataModule(data_cfg),
                             {"generated": gen_dir})
    launches = convert_all.launches_since(before)
    pretrained = bool(out.get("i3d_pretrained"))
    score = out.get("FVD", out.get("FVD_UNPRETRAINED"))
    res = {
        "model": model,
        "fvd": score,
        "fvd_key": "FVD" if pretrained else "FVD_UNPRETRAINED",
        "published": anchor,
        "n_videos": out.get("n"),
        "i3d_pretrained": pretrained,
        "synthetic_data": synthetic,
        "launches": launches,
        "seconds": {"load": load_s, "fvd": time.perf_counter() - t0},
    }
    blockers = []
    if not pretrained:
        blockers.append("unpretrained I3D")
    if synthetic:
        blockers.append("synthetic data")
    if anchor is None:
        blockers.append("no published number")
    if blockers and not (allow_blocked and anchor is not None):
        res["gate"] = "blocked: " + ", ".join(blockers)
    else:
        passed = bool(score <= anchor * 1.02)
        res["gate"] = "pass" if passed else "fail"
        res["within_2pct"] = passed
        if blockers:
            res["gate_note"] = ("computed despite " + ", ".join(blockers) +
                                " (--allow-blocked-gates); NOT a quality claim")
    return res


def run(datapath: Optional[str] = None, models: Optional[list] = None,
        out_root: Optional[str] = None, weights_out: Optional[str] = None,
        n_samples_fvd: int = 1000, batch: int = 16, skip_fvd: bool = False,
        skip_backbones: bool = False, published: Optional[dict] = None,
        allow_blocked: bool = False, device=None):
    """(report, exit code) of the whole gate."""
    report = {"datapath": None, "models": [], "backbones": {}, "gates": []}
    root = detect_datapath(datapath)
    if root is None:
        report["status"] = ("no reference checkpoint tree found (searched "
                            f"--datapath, $DATAPATH, {CANDIDATE_MOUNTS}); "
                            "mount the reference logs/ tree and rerun")
        return report, 0
    report["datapath"] = root
    out_root = out_root or root
    if models:
        # an unknown name is reported up front, not as a KeyError after the work
        unknown = [m for m in models if m not in registry.MODELS]
        if unknown:
            report["unknown_models"] = sorted(unknown)
            models = [m for m in models if m in registry.MODELS]
    found = [m for m in (models or detect_models(root))
             if convert_all._best_ckpt(os.path.join(root, "logs", "second_stage", "ckpt", m))]
    report["models_found"] = found
    if not found:
        report["status"] = "tree mounted but no released model checkpoints found"
        return report, 0

    ok = True
    for m in found:
        res = convert_all.convert_model(root, m, out_root, verify=True, device=device)
        report["models"].append(res)
        print(json.dumps(res, default=str), flush=True)
        if res.get("status") != "converted" or not (
                res.get("flow_roundtrip_ok") and res.get("sample_finite")):
            ok = False
    if not skip_backbones:
        wdir = weights_out or os.environ.get(
            "IPOKE_WEIGHTS", os.path.join(out_root, "logs", "weights"))
        os.makedirs(wdir, exist_ok=True)
        # the metrics read $IPOKE_WEIGHTS: the gate's FVD then runs on the
        # converted I3D (JAX's protocol: this process's environment changes)
        os.environ.setdefault("IPOKE_WEIGHTS", wdir)
        t0 = time.perf_counter()
        report["backbones"] = convert_all.convert_backbones(root, wdir)
        report["backbones_seconds"] = time.perf_counter() - t0
        print(json.dumps(report["backbones"], default=str), flush=True)

    if not skip_fvd:
        for res in report["models"]:
            if res.get("status") != "converted":
                continue
            m = res["model"]
            g = gate_model(root, m, res["out"], n_samples_fvd=n_samples_fvd, batch=batch,
                           published=(published or {}).get(m), allow_blocked=allow_blocked,
                           out_root=out_root, device=device)
            report["gates"].append(g)
            print(json.dumps(g, default=str), flush=True)
            if g["gate"] == "fail":
                ok = False

    report["status"] = "pass" if ok else "fail"
    return report, 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.ckpt.quality_gate",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--datapath", default=None)
    ap.add_argument("--out", default=None, help="output root (default: datapath)")
    ap.add_argument("--weights-out", default=None)
    ap.add_argument("--models", default=None, help="comma-separated subset")
    ap.add_argument("--n-samples-fvd", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--skip-fvd", action="store_true")
    ap.add_argument("--skip-backbones", action="store_true")
    ap.add_argument("--published", default=None,
                    help="JSON file or literal {model: fvd} overriding the "
                         "registry's published numbers (testing)")
    ap.add_argument("--allow-blocked-gates", action="store_true")
    ap.add_argument("--report", default=None, help="report JSON path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    published = None
    if args.published:
        if os.path.exists(args.published):
            with open(args.published) as f:
                published = json.load(f)
        else:
            published = json.loads(args.published)
    report, rc = run(
        datapath=args.datapath,
        models=args.models.split(",") if args.models else None,
        out_root=args.out, weights_out=args.weights_out,
        n_samples_fvd=args.n_samples_fvd, batch=args.batch,
        skip_fvd=args.skip_fvd, skip_backbones=args.skip_backbones,
        published=published, allow_blocked=args.allow_blocked_gates, device=device)
    rpt = args.report or os.path.join(args.out or report.get("datapath") or ".",
                                      "quality_gate_report.json")
    os.makedirs(os.path.dirname(rpt) or ".", exist_ok=True)
    with open(rpt, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"quality gate: {report.get('status')} -> {rpt}", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
