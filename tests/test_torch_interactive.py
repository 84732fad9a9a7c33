"""Poking an image: the port's ``eval/interactive`` session and CLI and the
``eval/gui`` HTTP app against the JAX package's, on the CPU at
tests/torch_port_util.py's tiny second stage (64x64, 3 frames; the
``model`` of tests/test_torch_eval.py).  The GUI is driven over HTTP on a
free port of 127.0.0.1.  The whole session against JAX's own is ``slow``."""
import base64
import http.client
import io
import json
import os
import threading

import jax
import numpy as np
import pytest
import yaml
from PIL import Image

from ipoke_tpu.data.poke import poke_from_coords as jpoke_from_coords
from ipoke_tpu_torch.eval import gui, interactive
from ipoke_tpu_torch.utils.video import to_uint8
from test_torch_eval import _jax_keys, _jax_model, model  # noqa: F401
from torch_port_util import tiny_config

POKES = [{"x": 100, "y": 40, "dx": 8, "dy": -3}, {"x": 10.5, "y": 201, "dx": -5, "dy": 2.5}]
FLOW_TOL = 2e-4   # videos against JAX's, relative to 1 + max|ref|


def _session(model, **kw):
    _, spec, params, batches = model
    sess = interactive.InteractiveSession(params, spec, **kw)
    sess.set_image(batches[0]["images"][0, 0])
    return sess


@pytest.mark.parametrize("display_size", [256, 224])
def test_poke_map_is_jax_poke_from_coords_after_scaling(model, display_size):
    """Display coordinates scaled by size / display_size, (y, x) and (dy, dx)
    as JAX's session orders them; an empty list gives a zero poke."""
    sess = _session(model, display_size=display_size)
    s = 64 / display_size
    want = jpoke_from_coords((64, 64), np.array([[p["y"] * s, p["x"] * s] for p in POKES]),
                             np.array([[p["dy"] * s, p["dx"] * s] for p in POKES]), poke_size=5)
    got = sess.poke_map(POKES)
    assert got.dtype == want.dtype and np.array_equal(got, want) and np.abs(got).sum() > 0
    assert np.array_equal(sess.poke_map([]), np.zeros((64, 64, 2), np.float32))


@pytest.mark.parametrize("fixed_seed", [False, True])
def test_keys_follow_jax_session(model, fixed_seed):
    """A split chain from PRNGKey(42), one key per call; PRNGKey(42) on every
    call with fixed_seed."""
    sess = _session(model, fixed_seed=fixed_seed)
    got = [sess.next_key() for _ in range(3)]
    root = tuple(int(v) for v in np.asarray(jax.random.PRNGKey(42)))
    assert got == ([root] * 3 if fixed_seed else _jax_keys(42, 3))


def test_generate_past_the_trained_horizon(model):
    """The trained horizon is 2 frames (max_frames 3); 5 decode, finite; the
    default length is max_frames - 1; two calls draw two keys."""
    sess = _session(model)
    vid, poke = sess.generate(POKES, length=5)
    assert vid.shape == (5, 64, 64, 3) and vid.dtype == np.float32 and np.all(np.isfinite(vid))
    assert np.array_equal(poke, sess.poke_map(POKES))
    again, _ = sess.generate(POKES)
    assert again.shape == (2, 64, 64, 3) and not np.array_equal(again, vid[:2])
    fixed = _session(model, fixed_seed=True)
    assert np.array_equal(fixed.generate([])[0], fixed.generate([])[0])


def _config_file(tmp_path, model):
    cfg = dict(tiny_config(tmp_path / "logs"), data=dict(model[0]["data"]), ui={"display_size": 64})
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_prints_jax_json_line(model, tmp_path, capsys):
    """The run loaded as ``test`` loads it (no checkpoint: every component
    from the seed), test example 1's start frame; the files and JAX's JSON
    line {"frames", "out"}."""
    out = interactive.main(["-c", _config_file(tmp_path, model), "-m", "m", "--pokes",
                            json.dumps(POKES[:1]), "--length", "3", "--example", "1",
                            "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == {"frames", "out"} and line["frames"] == 3
    assert line["out"].startswith(str(tmp_path / "logs" / "serve_ckpt" / "generated" / "m" / "interactive"))
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(line["out"]))
    assert stems == ["enrollment", "generated"]
    assert Image.open(os.path.join(line["out"], "enrollment.png")).size == (4 * 66 - 2, 64)


# ---------------------------------------------------------------------------
# the GUI over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture
def served(model):
    """The GUI of a tiny session (display size 64) on a free port, serving
    on a thread; shut down after the test."""
    batches = model[3]
    sess = _session(model, display_size=64)
    server = gui.make_server(sess, lambda i: batches[i // 2]["images"][i % 2, 0], port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield sess, server.server_address[1], batches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _decode(data_url):
    assert data_url.startswith("data:image/png;base64,")
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(data_url.split(",", 1)[1]))))


def test_gui_endpoints(served):
    sess, port, batches = served
    status, ctype, body = _request(port, "GET", "/")
    assert status == 200 and ctype == "text/html" and body.decode() == gui.PAGE
    status, ctype, body = _request(port, "GET", "/frame?ts=1")
    assert status == 200 and ctype == "image/png"
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(body))), to_uint8(batches[0]["images"][0, 0]))
    status, _, body = _request(port, "GET", "/example?i=1")
    assert status == 200 and json.loads(body) == {"ok": True}
    assert np.array_equal(sess.image, batches[0]["images"][1, 0])
    status, ctype, body = _request(port, "POST", "/poke", json.dumps({"pokes": POKES, "length": 4}))
    reply = json.loads(body)
    assert status == 200 and ctype == "application/json" and set(reply) == {"frames", "seconds"}
    frames = [_decode(u) for u in reply["frames"]]
    assert len(frames) == 4 + 1 and all(f.shape == (64, 64, 3) for f in frames)
    assert np.array_equal(frames[0], to_uint8(batches[0]["images"][1, 0]))


def test_gui_reports_a_failed_request_as_json_500(served):
    _, port, _ = served
    status, ctype, body = _request(port, "POST", "/poke", b"{not json")
    reply = json.loads(body)
    assert status == 500 and ctype == "application/json" and set(reply) == {"error", "trace"}
    status, _, body = _request(port, "POST", "/poke", json.dumps({"pokes": [], "length": 2}))
    assert status == 200 and len(json.loads(body)["frames"]) == 3     # the server serves on


@pytest.mark.parametrize("size,display", [(64, 256), (64, 100), (64, 224), (128, 64), (37, 256)])
def test_frame_resize_is_pil_nearest(size, display):
    img = np.random.default_rng(size + display).integers(0, 256, (size, size, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((display, display), Image.NEAREST))
    assert np.array_equal(gui.resize_nearest(img, display), want)


@pytest.mark.slow
def test_session_matches_jax_session(model):
    """Two pokes through the port's session and JAX's on the same params and
    start frame: the same poke maps, videos within FLOW_TOL."""
    from ipoke_tpu.eval.interactive import InteractiveSession as JaxSession

    cfg, spec, params, batches = model
    jspec, jparams = _jax_model(cfg, spec, params)
    sess = _session(model)
    jsess = JaxSession(jparams, jspec)
    jsess.set_image(batches[0]["images"][0, 0])
    for pokes, length in ((POKES, None), (POKES[:1], 4)):
        vid, poke = sess.generate(pokes, length=length)
        jvid, jpoke = jsess.generate(pokes, length=length)
        assert np.array_equal(poke, np.asarray(jpoke))
        ref = np.asarray(jvid)
        assert vid.shape == ref.shape
        assert np.abs(vid - ref).max() <= FLOW_TOL * (1 + np.abs(ref).max())


def test_saved_config_is_never_seen_truncated(tmp_path, monkeypatch):
    """The entry points of one run (``eval.gui`` and ``eval.interactive``
    started together) each save its config: a reader in the middle of a
    save sees the old file or the new one, never a truncated one (the GUI
    child once read an empty config.yaml while the other child wrote it)."""
    from ipoke_tpu_torch import config

    path = tmp_path / "config" / "config.yaml"
    config.save_yaml({"general": {"experiment": "a"}}, str(path))
    yaml_mod, seen = config._yaml(), []
    real_dump = yaml_mod.safe_dump

    def dump(cfg, f, **kw):
        seen.append(config.load_yaml(str(path)))   # another process reads meanwhile
        return real_dump(cfg, f, **kw)

    monkeypatch.setattr(yaml_mod, "safe_dump", dump)
    config.save_yaml({"general": {"experiment": "b"}}, str(path))
    assert seen == [{"general": {"experiment": "a"}}]
    assert config.load_yaml(str(path)) == {"general": {"experiment": "b"}}
    assert os.listdir(path.parent) == ["config.yaml"]
