"""HTTP front end over the dynamic batcher (counterpart of
``ipoke_tpu/serve/server.py``).

    python -m ipoke_tpu_torch.serve.server --synth-model iper_128 [--port 8700]
        [--max-batch 8] [--max-delay-ms 30] [--wire-u8] [--device cpu]
    python -m ipoke_tpu_torch.serve.server -c <cfg> -m <name> [...]
    python -m ipoke_tpu_torch.serve.server --artifact DIR [...]

Endpoints (JSON unless noted):
  GET  /healthz        -> {"ok": true} once warmed
  GET  /stats          -> batcher stats (request count, batch histogram,
                          mean wait / exec times)
  POST /sample         body {"x0": [[...]], "poke": [[...]], "seed": N,
                        "format": "json"|"npy"|"npy_u8"}
                       x0: (S,S,3) in [-1,1]; poke: (S,S,2); response
                       {"video": nested list (T,S,S,3)} or raw npy bytes.
                       Binary fast path: Content-Type application/octet-stream
                       with an np.savez body ({'x0','poke','seed'[,'format']})
                       -> npy response; skips the JSON parse.

The server runs on the CUDA card; ``--device cpu`` runs it on the CPU, and
only when asked.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _npy_header(shape, dtype):
    """The npy v1 header bytes for (shape, dtype), computed once per shape so
    responses are written as header bytes + memoryview(array), with no
    BytesIO round trip of the video."""
    buf = io.BytesIO()
    np.save(buf, np.empty(shape, dtype))
    header_len = buf.tell() - int(np.prod(shape)) * np.dtype(dtype).itemsize
    return buf.getvalue()[:header_len]


def make_handler(batcher):
    ready = threading.Event()
    ready.set()
    header_cache = {}

    def npy_body_parts(arr):
        key = (arr.shape, arr.dtype.str)
        hdr = header_cache.get(key)
        if hdr is None:
            hdr = header_cache[key] = _npy_header(arr.shape, arr.dtype)
        return hdr, memoryview(np.ascontiguousarray(arr)).cast("B")

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 + Content-Length on every response => persistent
        # connections; clients reusing sockets skip per-request TCP setup
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_npy(self, arr):
            hdr, mv = npy_body_parts(arr)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(hdr) + len(mv)))
            self.end_headers()
            self.wfile.write(hdr)
            self.wfile.write(mv)  # zero-copy: straight from the result array

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, json.dumps({"ok": ready.is_set()}).encode())
            elif self.path.startswith("/stats"):
                self._send(200, json.dumps(batcher.stats.snapshot()).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if not self.path.startswith("/sample"):
                self._send(404, b'{"error": "not found"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if "octet-stream" in (self.headers.get("Content-Type") or ""):
                    z = np.load(io.BytesIO(raw))
                    payload = {"format": str(z["format"]) if "format" in z
                               else "npy"}
                    x0 = np.asarray(z["x0"], np.float32)
                    poke = np.asarray(z["poke"], np.float32)
                    seed = int(z["seed"]) if "seed" in z else 0
                else:
                    payload = json.loads(raw)
                    x0 = np.asarray(payload["x0"], np.float32)
                    poke = np.asarray(payload["poke"], np.float32)
                    seed = int(payload.get("seed", 0))
                vid = batcher.submit(x0, poke, seed=seed, timeout=300)
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            fmt = payload.get("format", "json")
            vid = np.asarray(vid)
            wire_u8 = vid.dtype == np.uint8  # batcher quantised on the device
            if fmt == "npy_u8":
                # a quarter of the response bytes: [-1,1] float -> uint8
                # pixels (the quantisation the mp4/eval writers apply)
                if not wire_u8:
                    vid = np.clip((vid + 1.0) * 127.5, 0, 255).astype(np.uint8)
                self._send_npy(vid)
            elif fmt == "npy":
                if wire_u8:
                    vid = vid.astype(np.float32) / 127.5 - 1.0
                self._send_npy(vid)
            else:
                if wire_u8:
                    vid = vid.astype(np.float32) / 127.5 - 1.0
                self._send(200, json.dumps({"video": vid.tolist()}).encode())

    return Handler


def serve(batcher, port=8700):
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(batcher))
    print(f"ipoke-tpu-torch serve: listening on :{port}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        batcher.close()


def resolve_model(config=None, model=None, synth_model=None, device=None):
    """(params, spec) on ``device`` from either a checkpoint (-c/-m) or a
    registry architecture on synthesised params (--synth-model, for load
    testing the serving path itself)."""
    from dataclasses import replace

    from ipoke_tpu_torch import resolve_device

    device = resolve_device(device)
    if synth_model:
        from ipoke_tpu_torch import registry
        from ipoke_tpu_torch.utils.synth import synth_params, zero_flow_output_convs

        spec = registry.build_specs(registry.MODELS[synth_model])
        # bf16 decode, the sampling configuration the JAX server serves
        spec = replace(spec, first_stage=replace(spec.first_stage, decode_dtype="bf16"))
        params = synth_params(spec, device=device)
        params = dict(params, flow=zero_flow_output_convs(params["flow"]))
        return params, spec
    if not (config and model):
        raise SystemExit("need -c/-m (checkpoint serving) or --synth-model")
    from ipoke_tpu_torch.config import load_parameters
    from ipoke_tpu_torch.experiments.second_stage import load_for_serving

    cfg, dirs = load_parameters(config, model, test_mode="samples")
    return load_for_serving(cfg, dirs, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("--synth-model", default=None, metavar="REGISTRY_NAME",
                    help="serve a registry architecture (e.g. iper_128) on "
                         "synthesised params, no checkpoint needed; for "
                         "load testing the serving path itself")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="serve an exported artifact (serve/artifact.py): no model "
                         "code runs; it must have been exported for this device type")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=30.0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card; "
                         "'cpu' only when asked, there is no fallback)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--wire-u8", action="store_true",
                    help="quantise videos to uint8 on the device ([-1,1] -> "
                         "0..255, the mp4 writers' quantisation): a quarter "
                         "of the device-to-host bytes. npy(f32)/json "
                         "responses are dequantised from the u8 wire; with "
                         "--artifact, it needs one exported with --wire-u8")
    args = ap.parse_args(argv)

    from ipoke_tpu_torch import resolve_device
    from ipoke_tpu_torch.serve.batcher import BatcherConfig, SampleBatcher

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    cfg = BatcherConfig(max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
                        wire_u8=args.wire_u8)
    if args.artifact:
        from ipoke_tpu_torch.serve.artifact import load_artifact

        batcher = SampleBatcher.from_artifact(load_artifact(args.artifact, device), cfg)
    else:
        params, spec = resolve_model(args.config, args.model, args.synth_model, device)
        batcher = SampleBatcher(params, spec, cfg)
    if not args.no_warmup:
        print("ipoke-tpu-torch serve: warming batch buckets...", flush=True)
        batcher.warmup()
    serve(batcher, args.port)


if __name__ == "__main__":
    main()
