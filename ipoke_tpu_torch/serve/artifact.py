"""Serving artifacts: export once, serve without the model code (counterpart
of ``ipoke_tpu/serve/artifact.py``).

An artifact is a directory:

    manifest.json      shapes, buckets, unroll length, wire, format version,
                       torch version and the device type it was exported for
    params.npz         the parameter tree in JAX's ckpt/io npz layout
    sampler_b<B>.pt2   ``torch.export`` of the whole sample step (flow
                       reverse or direct student, then decode) at batch
                       bucket B, saved by ``torch.export.save``

The params are inputs of each exported program, never constants: the
flagship tree is 4.25 GB, and each bucket file would hold a copy.  The MCF
inverses are the custom ops ``ipoke::macow_unit_inverse`` and
``ipoke::mcf_inverse`` (``ops/cuda``): an exported flow sampler holds one
node per MaCowUnit (or MCF), and ``load_artifact`` imports the ops' module so
that they are registered.  Tensor factories inside the traced path carry the
export device, so an artifact runs on the device type it was exported for
and ``load_artifact`` refuses any other.

    python -m ipoke_tpu_torch.serve.artifact export --synth-model iper_128 \\
        --out DIR [--buckets 1,2,4,8] [--length N] [--device cpu] \\
        [--student-ckpt NPZ | --student-synth] [--wire-u8]
    python -m ipoke_tpu_torch.serve.artifact export -c <cfg> -m <name> --out DIR
    python -m ipoke_tpu_torch.serve.artifact verify --dir DIR [--device cpu]
"""
from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.ckpt import io
from ipoke_tpu_torch.ckpt.jax_bridge import (
    bridge_components, bridge_direct, grown_adapters, unbridge_direct, unbridge_second_stage)
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.ops.cuda import mcf_unit_inverse  # noqa: F401  registers the custom ops
from ipoke_tpu_torch.train import distill
from ipoke_tpu_torch.train.second_stage import leaves
from ipoke_tpu_torch.utils import prng

log = logging.getLogger(__name__)

FORMAT_VERSION = 1


class _Sampler(torch.nn.Module):
    """``(params, x0, poke, z) -> video``: the sample step the artifact exports."""

    def __init__(self, spec, length, student=None, wire_u8=False):
        super().__init__()
        self.spec, self.length, self.student, self.wire_u8 = spec, length, student, wire_u8

    def forward(self, params, x0, poke, z):
        batch = {"images": x0[:, None], "poke": poke}
        if self.student is None:
            v = second_stage.forward_sample(params, self.spec, batch, length=self.length,
                                            add_first_frame=True, z=z)[0]
        else:
            v = distill.forward_sample_student(params["base"], params["student"], self.student,
                                               self.spec, batch, length=self.length,
                                               add_first_frame=True, z=z)[0]
        if self.wire_u8:
            # float -> uint8 truncates, as JAX's astype does
            v = ((v + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)
        return v


def z_shape_of(spec):
    """Per-example Gaussian input shape of the flow reverse pass."""
    return tuple(transformer.reverse_input_shape(
        spec.flow, 1, spec.latent_size, spec.flow_in_channels)[1:])


def _bridge(tree, manifest, device):
    """params.npz's tree (JAX layout) -> the exported programs' params."""
    grown = manifest["transposed_adapters"]
    if manifest["sampler"] == "direct_student":
        return {"base": bridge_components(tree["base"], grown, device),
                "student": bridge_direct(tree["student"], device)}
    return bridge_components(tree, grown, device)


def export_sampler(params, spec, out_dir, buckets: Sequence[int] = (1, 2, 4, 8),
                   length: Optional[int] = None, student=None, wire_u8: bool = False):
    """Export the sample step at every batch bucket on the device of
    ``params`` and write the artifact directory.

    ``student=(student_params, DirectStudentSpec)`` exports the distilled
    direct sampler instead of the flow reverse, with the same z input; its
    params are ``{'base': the teacher's less its flow, 'student': ...}``.
    ``wire_u8`` puts the [-1,1] -> uint8 pixel quantisation (the mp4
    writers') into the exported program; the manifest says ``wire: "u8"``.
    The seconds each bucket took to export go to the manifest's
    ``export_s``."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    length = length or (spec.first_stage.max_frames - 1)
    s = spec.first_stage.spatial_size
    zs = z_shape_of(spec)
    device = leaves(params)[0].device
    base = {k: v for k, v in params.items() if k != "flow"} if student is not None else params
    tree = unbridge_second_stage(base, spec)
    if student is not None:
        # the student replaces the flow reverse: the flow tree would be dead
        # weight in the artifact and in serving memory
        tree = {"base": tree, "student": unbridge_direct(student[0])}
    manifest = {
        "format_version": FORMAT_VERSION,
        "sampler": "direct_student" if student is not None else "flow",
        "wire": "u8" if wire_u8 else "f32",
        "buckets": sorted(int(b) for b in buckets),
        "length": int(length),
        "x0_shape": [s, s, 3],
        "poke_shape": [s, s, 2],
        "z_shape": [int(d) for d in zs],
        "torch_version": torch.__version__,
        "device": device.type,
        "transposed_adapters": grown_adapters(spec),
    }
    # the params as the loader rebuilds them from params.npz, so the
    # programs' input tree is the one they will be called with
    p = _bridge(tree, manifest, device)
    sampler = _Sampler(spec, int(length), None if student is None else student[1], wire_u8)
    export_s = {}
    for b in manifest["buckets"]:
        args = (p, torch.zeros((b, s, s, 3), device=device), torch.zeros((b, s, s, 2), device=device),
                torch.zeros((b,) + zs, device=device))
        t0 = time.perf_counter()
        # under no_grad, so the model's own no_grad blocks trace as nothing
        # (as set_grad_enabled wrappers they do not survive save and load)
        with torch.no_grad():
            ep = torch.export.export(sampler, args, strict=False)
        # the example inputs hold the params; the file keeps the program only
        ep.example_inputs = None
        torch.export.save(ep, out / f"sampler_b{b}.pt2")
        export_s[str(b)] = time.perf_counter() - t0
        log.info("exported bucket %d in %.1f s", b, export_s[str(b)])
    del p
    io.save(str(out / "params.npz"), tree)
    manifest["export_s"] = export_s
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out


class LoadedSampler:
    """A loaded artifact: a runnable sampler, no model code needed.

    ``run(params, x0, poke, z)`` takes tensors on the artifact's device, with
    x0.shape[0] an exported bucket (the batcher pads to buckets);
    ``sample(x0, poke, seed)`` is the one-request convenience that pads to
    the smallest bucket.
    """

    def __init__(self, path, device=None):
        path = pathlib.Path(path)
        device = resolve_device(device)
        m = json.loads((path / "manifest.json").read_text())
        if m["format_version"] != FORMAT_VERSION:
            raise ValueError(f"artifact format {m['format_version']} != supported {FORMAT_VERSION}")
        if m["device"] != device.type:
            raise ValueError(
                f"artifact {path} was exported for {m['device']} and cannot run on "
                f"{device.type}: its programs carry their export device; re-export it there")
        self.manifest = m
        self.device = device
        self.buckets = list(m["buckets"])
        self.length = int(m["length"])
        self.x0_shape = tuple(m["x0_shape"])
        self.poke_shape = tuple(m["poke_shape"])
        self.z_shape = tuple(m["z_shape"])
        tree, _ = io.load(str(path / "params.npz"))
        self.params = _bridge(tree, m, device)
        self.programs = {b: torch.export.load(path / f"sampler_b{b}.pt2") for b in self.buckets}

    def run(self, params, x0, poke, z):
        b = int(x0.shape[0])
        if b not in self.programs:
            raise ValueError(f"batch {b} is not an exported bucket {self.buckets}")
        for name, t, shape in (("x0", x0, self.x0_shape), ("poke", poke, self.poke_shape),
                               ("z", z, self.z_shape)):
            if tuple(t.shape) != (b,) + shape:
                raise ValueError(f"{name} {tuple(t.shape)} is not ({b}, *{shape})")
        # the program's graph called on the flat inputs: ExportedProgram.module()
        # would add input checks but takes seconds per program to build
        ep = self.programs[b]
        flat, in_spec = pytree.tree_flatten(((params, x0, poke, z), {}))
        if in_spec != ep.call_spec.in_spec:
            raise ValueError("params do not have the tree the artifact was exported with")
        with torch.no_grad():
            out = ep.graph_module(*flat)
        return pytree.tree_unflatten(list(out), ep.call_spec.out_spec)

    def draw_z(self, seeds):
        """JAX's ``normal(PRNGKey(seed), z_shape)`` for each seed, stacked, on
        the artifact's device."""
        return prng.normal_for_seeds([int(sd) & prng.MASK for sd in seeds], self.z_shape,
                                     self.device)

    def sample(self, x0, poke, seed: int = 0):
        """One request -> (T, S, S, 3) video (pads to the smallest bucket)."""
        b = self.buckets[0]
        x0b = torch.zeros((b,) + self.x0_shape, device=self.device)
        pokeb = torch.zeros((b,) + self.poke_shape, device=self.device)
        x0b[0] = torch.as_tensor(np.asarray(x0, np.float32), device=self.device)
        pokeb[0] = torch.as_tensor(np.asarray(poke, np.float32), device=self.device)
        return self.run(self.params, x0b, pokeb, self.draw_z([seed] * b))[0].cpu().numpy()


def load_artifact(path, device=None) -> LoadedSampler:
    return LoadedSampler(path, device)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.serve.artifact")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="export a serving artifact")
    ex.add_argument("-c", "--config", default=None)
    ex.add_argument("-m", "--model", default=None)
    ex.add_argument("--synth-model", default=None, metavar="REGISTRY_NAME")
    ex.add_argument("--out", required=True)
    ex.add_argument("--buckets", default="1,2,4,8")
    ex.add_argument("--length", type=int, default=None)
    ex.add_argument("--student-ckpt", default=None,
                    help="export the distilled DIRECT sampler from this checkpoint "
                         "(bench_distill --save) instead of the sequential flow reverse")
    ex.add_argument("--student-hidden", type=int, default=256)
    ex.add_argument("--student-depth", type=int, default=6)
    ex.add_argument("--student-synth", action="store_true",
                    help="a fresh student from init_direct at key 5 (infra testing only)")
    ex.add_argument("--wire-u8", action="store_true",
                    help="put the uint8 pixel wire into the exported programs")
    vf = sub.add_parser("verify", help="load an artifact and run one sample")
    vf.add_argument("--dir", required=True)
    for p in (ex, vf):
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None

    if args.cmd == "export":
        from ipoke_tpu_torch.serve.server import resolve_model

        params, spec = resolve_model(args.config, args.model, args.synth_model, device)
        student = None
        if args.student_ckpt or args.student_synth:
            ds = distill.DirectStudentSpec(hidden=args.student_hidden, depth=args.student_depth)
            if args.student_ckpt:
                tree, smeta = io.load(args.student_ckpt)
                if smeta and smeta.get("hidden"):
                    ds = distill.DirectStudentSpec(hidden=int(smeta["hidden"]),
                                                   depth=int(smeta["depth"]))
                sparams = bridge_direct(tree, device)
            else:
                sparams = distill.init_direct(prng.prng_key(5), spec, ds, device)
            student = (sparams, ds)
        out = export_sampler(params, spec, args.out,
                             buckets=[int(b) for b in args.buckets.split(",")],
                             length=args.length, student=student, wire_u8=args.wire_u8)
        print(f"exported artifact -> {out}", flush=True)
    else:
        art = load_artifact(args.dir, device)
        vid = art.sample(np.zeros(art.x0_shape, np.float32), np.zeros(art.poke_shape, np.float32),
                         seed=0)
        if vid.dtype != np.uint8 and not np.isfinite(vid).all():
            raise SystemExit("artifact verify: the video is not finite")
        print(f"artifact ok: buckets={art.buckets} video={vid.shape} {vid.dtype} "
              f"device={device}", flush=True)


if __name__ == "__main__":
    main()
