"""Poking a still image in a browser (counterpart of ``ipoke_tpu/eval/gui.py``;
the reference's testing/gui.py PyQt app): a standard-library HTTP app whose
canvas takes the place of the Qt widget.  A drag on the start frame is a
poke; ``eval/interactive.InteractiveSession`` turns it into a video (the
flow's reverse, K2 on the card), which the page plays in place
(testing/gui.py:120-150, 326-376).

    python -m ipoke_tpu_torch.eval.gui -c <cfg> -m <name> [--port 8765] [--device cpu]

Endpoints: ``GET /`` (the page), ``GET /frame`` (the start frame as a PNG at
the display size), ``GET /example?i=N`` (test example N's start frame),
``POST /poke`` with ``{"pokes": [{x, y, dx, dy}, ...], "length": T}`` ->
``{"frames": [PNG data URLs, the start frame first], "seconds"}``.  A failed
request gets status 500 with ``{"error", "trace"}``.  One lock serialises the
session: each request samples on its handler's thread, on the device's
current stream.  It prints ``ipoke-tpu GUI: http://127.0.0.1:<port>`` once
it serves.  It runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import base64
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ipoke_tpu_torch.utils.video import png_bytes, to_uint8

PAGE = """<!doctype html>
<html><head><title>ipoke-tpu interactive</title><style>
body { font-family: sans-serif; background: #111; color: #ddd; margin: 2em; }
canvas { border: 1px solid #555; image-rendering: pixelated; }
#row { display: flex; gap: 2em; }
.col { text-align: center; }
#status { margin-top: 1em; color: #8c8; }
</style></head><body>
<h2>ipoke-tpu &mdash; poke a still image</h2>
<div id="row">
  <div class="col"><div>drag to poke</div><canvas id="src" width="256" height="256"></canvas></div>
  <div class="col"><div>generated</div><canvas id="dst" width="256" height="256"></canvas></div>
</div>
<div>length <input id="len" type="number" value="9" min="1" max="60" style="width:4em">
 example <input id="ex" type="number" value="0" min="0" style="width:4em">
 <button onclick="loadExample()">load</button></div>
<div id="status">ready</div>
<script>
const src = document.getElementById('src'), dst = document.getElementById('dst');
const sctx = src.getContext('2d'), dctx = dst.getContext('2d');
let frameImg = new Image(), drag = null, frames = [], fi = 0;
frameImg.onload = () => sctx.drawImage(frameImg, 0, 0, 256, 256);
function refresh() { frameImg.src = '/frame?ts=' + Date.now(); }
refresh();
src.onmousedown = e => { const r = src.getBoundingClientRect();
  drag = {x: e.clientX - r.left, y: e.clientY - r.top}; };
src.onmousemove = e => { if (!drag) return;
  const r = src.getBoundingClientRect();
  sctx.drawImage(frameImg, 0, 0, 256, 256);
  sctx.strokeStyle = '#f55'; sctx.lineWidth = 2; sctx.beginPath();
  sctx.moveTo(drag.x, drag.y);
  sctx.lineTo(e.clientX - r.left, e.clientY - r.top); sctx.stroke(); };
src.onmouseup = async e => { if (!drag) return;
  const r = src.getBoundingClientRect();
  const poke = {x: drag.x, y: drag.y,
                dx: (e.clientX - r.left) - drag.x, dy: (e.clientY - r.top) - drag.y};
  drag = null;
  document.getElementById('status').textContent = 'generating...';
  const resp = await fetch('/poke', {method: 'POST',
    body: JSON.stringify({pokes: [poke], length: +document.getElementById('len').value})});
  const data = await resp.json();
  frames = data.frames.map(u => { const im = new Image(); im.src = u; return im; });
  document.getElementById('status').textContent =
    'generated ' + frames.length + ' frames in ' + data.seconds.toFixed(2) + 's';
};
async function loadExample() {
  await fetch('/example?i=' + document.getElementById('ex').value);
  refresh();
}
setInterval(() => { if (frames.length) {
  dctx.drawImage(frames[fi % frames.length], 0, 0, 256, 256); fi++; } }, 120);
</script></body></html>
"""



def _png_data_url(frame_m11):
    return "data:image/png;base64," + base64.b64encode(png_bytes(frame_m11)).decode()


def _nearest_index(n_in, n_out):
    """PIL's nearest source pixels: the centre of output pixel 0 at half a
    step, each next one step further, summed one step at a time in double
    precision (its affine transform's loop), then truncated."""
    step = n_in / n_out
    return np.add.accumulate(np.r_[step * 0.5, np.full(n_out - 1, step)]).astype(np.int64)


def resize_nearest(img, size):
    """(H, W, C) ``img`` at ``size`` x ``size`` by nearest neighbour, as PIL's
    ``resize(..., Image.NEAREST)`` picks its source pixels."""
    return img[_nearest_index(img.shape[0], size)][:, _nearest_index(img.shape[1], size)]


def make_handler(session, examples):
    """The request handler of ``session`` (an ``InteractiveSession``);
    ``examples``: index -> a start frame (H, W, 3) in [-1, 1]."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _send(self, body, ctype="text/html", status=200):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.startswith("/frame"):
                with lock:
                    frame = to_uint8(session.image)
                self._send(png_bytes(resize_nearest(frame, session.display_size)), "image/png")
            elif self.path.startswith("/example"):
                idx = int(self.path.split("=")[-1]) if "=" in self.path else 0
                with lock:
                    session.set_image(examples(idx))
                self._send(json.dumps({"ok": True}), "application/json")
            else:
                self._send(PAGE)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                t0 = time.time()
                with lock:
                    vid, _ = session.generate(req.get("pokes", []), length=req.get("length"))
                    clip = np.concatenate([session.image[None], vid], 0)
                frames = [_png_data_url(f) for f in clip]
                self._send(json.dumps({"frames": frames, "seconds": time.time() - t0}),
                           "application/json")
            except Exception as e:   # noqa: BLE001  (report it, do not drop the connection)
                self._send(json.dumps({"error": str(e), "trace": traceback.format_exc()[-800:]}),
                           "application/json", status=500)

    return Handler


def make_server(session, examples, port=8765):
    """The GUI's HTTP server on 127.0.0.1:``port`` (0: a free port), bound
    but not yet serving."""
    return ThreadingHTTPServer(("127.0.0.1", port), make_handler(session, examples))


def serve(session, examples, port=8765):
    """Serve the GUI until interrupted."""
    server = make_server(session, examples, port)
    print(f"ipoke-tpu GUI: http://127.0.0.1:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.eval.gui")
    ap.add_argument("-c", "--config", default="configs/second_stage.yaml")
    ap.add_argument("-m", "--model_name", required=True)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--example", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    from ipoke_tpu_torch import resolve_device
    from ipoke_tpu_torch.eval.interactive import load_session

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    session, _, test_ds = load_session(args.config, args.model_name, device)

    def examples(i):
        return test_ds[i % len(test_ds)]["images"][0]

    session.set_image(examples(args.example))
    serve(session, examples, port=args.port)


if __name__ == "__main__":
    main()
