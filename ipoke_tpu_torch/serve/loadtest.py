"""Load-test client for ``serve/server.py`` (the port's copy of
``ipoke_tpu/serve/loadtest.py``): saturates the server from separate
processes, so client-side work does not share the interpreter lock with the
server's request threads.

    # server (synthetic iper_128 on the card):
    python -m ipoke_tpu_torch.serve.server --synth-model iper_128 --max-batch 8 &
    # load test:
    python -m ipoke_tpu_torch.serve.loadtest --port 8700 --requests 96 \
        --procs 2 --conns 8 --format npy_u8

Each connection is a persistent HTTP/1.1 socket (keep-alive) issuing
binary-npz requests back to back; prints one JSON line of served videos/s and
latency percentiles aggregated across processes (the keys of the JAX
package's line; numbers unrounded).  The client processes are
started by ``spawn``: a caller that already holds a CUDA context must not
pass it on by ``fork``.
"""
from __future__ import annotations

import argparse
import http.client
import io
import json
import multiprocessing as mp
import threading
import time

import numpy as np


def _client_proc(port, host, n_requests, n_conns, size, fmt, seed0, out_q):
    rng = np.random.default_rng(seed0)
    x0 = rng.uniform(-1, 1, (size, size, 3)).astype(np.float32)
    poke = np.zeros((size, size, 2), np.float32)
    poke[size // 2:size // 2 + 5, size // 2:size // 2 + 5] = 3.0
    body_buf = io.BytesIO()
    np.savez(body_buf, x0=x0, poke=poke, seed=np.int64(seed0),
             format=np.str_(fmt))
    body = body_buf.getvalue()
    lat, errs = [], [0]
    lock = threading.Lock()
    counter = [0]

    def worker():
        conn = http.client.HTTPConnection(host, port, timeout=600)
        while True:
            with lock:
                if counter[0] >= n_requests:
                    break
                counter[0] += 1
            t0 = time.monotonic()
            try:
                conn.request("POST", "/sample", body=body,
                             headers={"Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    with lock:
                        errs[0] += 1
                else:
                    arr = np.load(io.BytesIO(data))
                    if arr.ndim != 4:
                        raise ValueError(f"video of shape {arr.shape}")
                    with lock:
                        lat.append(time.monotonic() - t0)
            except Exception:
                with lock:
                    errs[0] += 1
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=600)
        conn.close()

    threads = [threading.Thread(target=worker) for _ in range(n_conns)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_end = time.monotonic()
    out_q.put({"lat": lat, "errors": errs[0], "wall": t_end - t_start,
               "t_start": t_start, "t_end": t_end})


def run(port, host="127.0.0.1", requests=96, procs=2, conns=8, size=128,
        fmt="npy_u8", timeout=900.0):
    """Run the load test; returns the dict that ``main`` prints.

    ``wall_s`` spans the first request sent to the last answer received, over
    all processes (one host's monotonic clock), so the processes' start-up
    under ``spawn`` is not counted against the server."""
    ctx = mp.get_context("spawn")
    per = requests // procs
    q = ctx.Queue()
    workers = [ctx.Process(target=_client_proc,
                           args=(port, host, per, conns, size, fmt, 1000 + i, q))
               for i in range(procs)]
    for p in workers:
        p.start()
    try:
        results = [q.get(timeout=timeout) for _ in workers]   # drain before join
        for p in workers:
            p.join()
    finally:
        for p in workers:
            if p.is_alive():
                p.terminate()
                p.join()
    wall = max(r["t_end"] for r in results) - min(r["t_start"] for r in results)
    lat = sorted(sum((r["lat"] for r in results), []))
    n_ok = len(lat)
    return {
        "requests_ok": n_ok,
        "errors": sum(r["errors"] for r in results),
        "wall_s": wall,
        "videos_per_s_served": n_ok / wall if wall else None,
        "p50_s": lat[n_ok // 2] if lat else None,
        "p95_s": lat[int(n_ok * 0.95)] if lat else None,
        "format": fmt,
        "procs": procs,
        "conns_per_proc": conns,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--requests", type=int, default=96,
                    help="total requests across all processes")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--conns", type=int, default=8,
                    help="persistent connections per process")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--format", default="npy_u8", choices=["npy", "npy_u8"])
    args = ap.parse_args(argv)
    print(json.dumps(run(args.port, args.host, args.requests, args.procs, args.conns,
                         args.size, args.format)))


if __name__ == "__main__":
    main()
