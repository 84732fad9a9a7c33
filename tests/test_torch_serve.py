"""The port's serving path (``ipoke_tpu_torch/serve``) on the CPU: the cases
of tests/test_serve.py on the port's batcher and HTTP server, a request
against the JAX ``SampleBatcher``'s answer for the same (x0, poke, seed), the
load-test client against the port's server, and checkpoint serving (-c/-m)
from a tree written by the JAX package's ``ckpt/io``.  The model is the tiny
second stage of tests/test_torch_slice.py, initialised by JAX (flow output
gains non-zero) and carried across by ``ckpt/jax_bridge``; its weights are
the JAX package's ``synth_tree`` fill, which needs no compile."""
import io
import json
import queue
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from ipoke_tpu.ckpt import io as jio
from ipoke_tpu.experiments.second_stage import build_spec_from_config as jax_build_spec
from ipoke_tpu.models import second_stage as jss
from ipoke_tpu.serve.batcher import BatcherConfig as JaxBatcherConfig
from ipoke_tpu.serve.batcher import SampleBatcher as JaxSampleBatcher
from ipoke_tpu.utils.synth import synth_tree
from ipoke_tpu_torch.ckpt.jax_bridge import bridge_second_stage
from ipoke_tpu_torch.experiments.second_stage import build_spec_from_config
from ipoke_tpu_torch.serve import loadtest
from ipoke_tpu_torch.serve.batcher import BatcherConfig, SampleBatcher
from ipoke_tpu_torch.serve.server import make_handler, resolve_model
from test_torch_slice import S, T, _jax_spec
from torch_port_util import CPU, flatten, np_tree, port_second_stage_spec, set_wn_gains, tiny_config

JAX_TOL = 2e-4      # the slice's f32 tolerance (tests/test_torch_slice.py)
SAME_TOL = 1e-5     # tests/test_serve.py: alone vs batched, HTTP vs direct
CKPT_S = 64         # a config's spec is validated: 64 is the least size of an 8x8 latent


def _jax_params(jspec, gain=0.05):
    p = synth_tree(lambda k: jss.init(k, jspec), jax.random.PRNGKey(0), seed=0)
    return dict(p, flow=set_wn_gains(p["flow"], gain))


@pytest.fixture(scope="module")
def model():
    jspec = _jax_spec()
    p = _jax_params(jspec)
    spec = port_second_stage_spec(jspec, mcf_backend="cuda_unit")
    return p, jspec, spec, bridge_second_stage(np_tree(p), spec, device=CPU)


@pytest.fixture(scope="module")
def batcher(model):
    _, _, spec, pt = model
    b = SampleBatcher(pt, spec, BatcherConfig(max_batch=4, max_delay_ms=60.0))
    yield b
    b.close()


@pytest.fixture(scope="module")
def server(batcher):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)


def _req(i):
    rng = np.random.default_rng(100 + i)
    return (rng.uniform(-1, 1, (S, S, 3)).astype(np.float32),
            rng.standard_normal((S, S, 2)).astype(np.float32))


def _wait_all(reqs):
    for r in reqs:
        assert r.event.wait(300)
        assert r.error is None, r.error
    return [r.result for r in reqs]


def test_single_request_roundtrip(batcher):
    x0, poke = _req(0)
    vid = batcher.submit(x0, poke, seed=7, timeout=300)
    assert vid.shape == (T, S, S, 3) and vid.dtype == np.float32
    assert np.isfinite(vid).all()
    # the first frame is the conditioning frame
    np.testing.assert_allclose(vid[0], x0, rtol=1e-5, atol=1e-5)


def test_request_matches_the_jax_batcher(model, batcher):
    """One request, bucket 1 on both sides: the port's draw of z from the
    seed and its forward_sample give the JAX server's video."""
    p, jspec, _, _ = model
    x0, poke = _req(1)
    seed = 2**40 + 3      # an int64 client seed: both mask it to 32 bits
    jb = JaxSampleBatcher(p, jspec, JaxBatcherConfig(max_batch=1, max_delay_ms=0.0))
    try:
        want = jb.submit(x0, poke, seed=seed, timeout=300)
    finally:
        jb.close()
    got = batcher.submit(x0, poke, seed=seed, timeout=300)
    assert got.shape == want.shape == (T, S, S, 3)
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)


def test_batch_composition_invariance(batcher):
    """The same (x0, poke, seed) gives the same video alone and batched."""
    solo = [batcher.submit(*_req(i), seed=i, timeout=300) for i in range(3)]
    batched = _wait_all([batcher.submit_async(*_req(i), seed=i) for i in range(3)])
    for a, b in zip(solo, batched):
        np.testing.assert_allclose(a, b, rtol=SAME_TOL, atol=SAME_TOL)


def test_batching_actually_happens(batcher):
    before = batcher.stats.batches
    _wait_all([batcher.submit_async(*_req(10 + i), seed=i) for i in range(4)])
    made = batcher.stats.batches - before
    assert made < 4, f"4 concurrent requests ran as {made} batches (no batching)"
    assert any(b > 1 for b in batcher.stats.batch_hist)


def test_backlog_drains_into_batches(model):
    """With max_delay_ms=0 a queue backlog must still coalesce."""
    _, _, spec, pt = model
    b = SampleBatcher(pt, spec, BatcherConfig(max_batch=4, max_delay_ms=0.0))
    try:
        _wait_all([b.submit_async(*_req(30 + i), seed=i) for i in range(12)])
        assert max(b.stats.batch_hist) > 1, f"12 backlogged requests never batched: {b.stats.batch_hist}"
    finally:
        b.close()


def test_odd_count_pads_to_bucket(batcher):
    """3 requests pad to the 4-bucket; padded slots give no result."""
    before = dict(batcher.stats.batch_hist)
    vids = _wait_all([batcher.submit_async(*_req(20 + i), seed=i) for i in range(3)])
    assert all(v.shape == (T, S, S, 3) for v in vids)
    assert max(batcher.stats.batch_hist) <= 4
    grew = {k: v - before.get(k, 0) for k, v in batcher.stats.batch_hist.items()}
    assert sum(grew.values()) >= 1 and set(k for k, v in grew.items() if v) <= {1, 2, 4}


@pytest.mark.parametrize("x0_shape,poke_shape", [((S, S, 2), (S, S, 2)), ((S, S, 3), (S, S, 3)),
                                                 ((S + 1, S, 3), (S, S, 2))])
def test_shape_validation(batcher, x0_shape, poke_shape):
    with pytest.raises(ValueError):
        batcher.submit_async(np.zeros(x0_shape), np.zeros(poke_shape))


def test_stats_snapshot(batcher):
    batcher.submit(*_req(5), seed=1, timeout=300)
    snap = batcher.stats.snapshot()
    assert set(snap) == {"requests", "batches", "batch_size_histogram", "mean_wait_ms",
                         "mean_batch_exec_ms"}
    assert snap["requests"] >= 1 and snap["batches"] >= 1
    assert snap["mean_batch_exec_ms"] > 0


def _post(port, body, ctype):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sample", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


@pytest.mark.parametrize("route", ["json", "npz", "npz_u8"])
def test_http_handler_contract(batcher, server, route):
    """Drive the HTTP handler through a real socket: /healthz, /stats, and
    /sample by JSON and by the binary npz route (npy and npy_u8 replies)."""
    port = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"] is True
    x0, poke = _req(40)
    direct = batcher.submit(x0, poke, seed=3, timeout=300)
    if route == "json":
        body = json.dumps({"x0": x0.tolist(), "poke": poke.tolist(), "seed": 3}).encode()
        vid = np.asarray(json.loads(_post(port, body, "application/json"))["video"], np.float32)
        np.testing.assert_allclose(vid, direct, rtol=SAME_TOL, atol=SAME_TOL)
    else:
        buf = io.BytesIO()
        extra = {"format": np.str_("npy_u8")} if route == "npz_u8" else {}
        np.savez(buf, x0=x0, poke=poke, seed=3, **extra)
        vid = np.load(io.BytesIO(_post(port, buf.getvalue(), "application/octet-stream")))
        if route == "npz":
            np.testing.assert_allclose(vid, direct, rtol=SAME_TOL, atol=SAME_TOL)
        else:
            assert vid.dtype == np.uint8
            want = np.clip((direct + 1.0) * 127.5, 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(vid, want)
    assert vid.shape == (T, S, S, 3)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
        assert json.loads(r.read())["requests"] >= 2
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, json.dumps({"x0": [[0.0]], "poke": [[0.0]]}).encode(), "application/json")
    assert e.value.code == 400


def test_wire_u8_matches_f32_quantized(model, batcher):
    """wire_u8 quantises on the device with the writers' mapping: within one
    LSB of the host-quantised f32 video, and dequantised within one step."""
    _, _, spec, pt = model
    b8 = SampleBatcher(pt, spec, BatcherConfig(max_batch=4, max_delay_ms=60.0, wire_u8=True))
    try:
        x0, poke = _req(3)
        v32 = batcher.submit(x0, poke, seed=11, timeout=300)
        vu8 = b8.submit(x0, poke, seed=11, timeout=300)
        assert vu8.dtype == np.uint8
        want = np.clip((np.asarray(v32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
        assert np.abs(vu8.astype(np.int16) - want.astype(np.int16)).max() <= 1
        deq = vu8.astype(np.float32) / 127.5 - 1.0
        assert np.abs(deq - np.clip(v32, -1, 1)).max() <= (1.0 / 127.5)
    finally:
        b8.close()


def test_loadtest_client_against_the_server(server):
    """The load-test client (its process body, run in a thread) gets a 200
    and a video for every request."""
    out = queue.Queue()
    loadtest._client_proc(server, "127.0.0.1", 6, 3, S, "npy_u8", 1000, out)
    res = out.get(timeout=5)
    assert res["errors"] == 0 and len(res["lat"]) == 6 and res["wall"] > 0


# -- checkpoint serving (-c/-m) ------------------------------------------------

def _config(tmp_path, ckpts):
    return tiny_config(tmp_path / "logs", ckpts, spatial=CKPT_S, frames=T)


@pytest.mark.parametrize("with_conditioner", [True, False])
def test_checkpoint_serving(tmp_path, with_conditioner):
    """-c/-m: frozen components from the config's ckpt paths, the flow from
    the run's best checkpoint (newest version dir that holds one), bitwise
    the bridge of the same tree; a component found nowhere is drawn by the
    port's init from the config's seed (JAX's own draw:
    tests/test_torch_init.py)."""
    import yaml

    from ipoke_tpu_torch.models import second_stage
    from ipoke_tpu_torch.utils import prng

    p = _jax_params(jax_build_spec(_config(tmp_path, {})))
    ckpts = {}
    for key, wrap in (("first_stage", False), ("poke_embedder", True), ("conditioner", False)):
        if key == "conditioner" and not with_conditioner:
            continue
        path = str(tmp_path / f"{key}.npz")
        jio.save(path, {key: p[key]} if wrap else p[key])
        ckpts[key] = path
    cfg = _config(tmp_path, ckpts)
    run = tmp_path / "logs" / "serve_ckpt" / "ckpt" / "m"
    other_flow = set_wn_gains(p["flow"], 0.0)
    jio.save(str(run / "0" / "FVD-val=20.5.npz"), {"step": 1, "params": {"flow": other_flow}})
    jio.save(str(run / "0" / "FVD-val=12.25.npz"), {"step": 3, "params": {"flow": p["flow"]}})
    (run / "1").mkdir()                               # a version dir left empty
    cfg_path = tmp_path / "second_stage.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    params, spec = resolve_model(str(cfg_path), "m", device="cpu")
    assert spec == build_spec_from_config(cfg) == port_second_stage_spec(
        jax_build_spec(cfg), mcf_backend="cuda_unit")
    want = bridge_second_stage(np_tree(p), spec, device=CPU)
    if not with_conditioner:
        want["conditioner"] = second_stage.init(prng.prng_key(0), spec, device=CPU,
                                                only=["conditioner"])["conditioner"]
    want, got = flatten(want), flatten(params)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
