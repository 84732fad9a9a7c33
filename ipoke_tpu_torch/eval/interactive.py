"""Poking a still image from a script (counterpart of
``ipoke_tpu/eval/interactive.py``; the model-facing part of the reference's
testing/gui.py PyQt app, Form.forward :120-150).  ``eval/gui.py`` serves the
same session to a browser.

    python -m ipoke_tpu_torch.eval.interactive -c <cfg> -m <name> \\
        --pokes '[{"x": 64, "y": 40, "dx": 8, "dy": -3}]' [--length 16] [--device cpu]

Pokes are given in display coordinates (``ui.display_size`` of the config,
256 by default) and scaled to the model's resolution as the GUI does
(testing/gui.py:326-350).  The CLI loads the run as ``test`` does (the best
checkpoint over the config's frozen components), takes the start frame of
test example ``--example``, writes ``generated.mp4`` (``.npy`` without cv2)
and ``enrollment.png`` under ``<generated>/interactive/<stamp>/`` (or
``--out``) and prints one JSON line ``{"frames", "out"}``.  It runs on the
CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ipoke_tpu_torch.data.poke import poke_from_coords
from ipoke_tpu_torch.eval.test_modes import params_device
from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.video import enrollment, save_image, save_video


class InteractiveSession:
    """A second-stage model and one start frame; ``generate`` makes a video
    from a user's pokes, of any length (the GRU runs past the trained
    horizon, second_stage_video.py:361-382).  The key of each call is the
    next of a ``split`` chain from ``prng_key(42)``, or ``prng_key(42)``
    itself on every call with ``fixed_seed``, as JAX's session draws them."""

    def __init__(self, params, spec, display_size=256, fixed_seed=False):
        self.params = params
        self.spec = spec
        self.display_size = display_size
        self.fixed_seed = fixed_seed
        self.device = params_device(params)
        self._rng = prng.prng_key(42)
        self.image = None

    def set_image(self, image):
        """image: (H, W, 3) in [-1, 1] at the model's resolution."""
        self.image = np.asarray(image, np.float32)

    def next_key(self):
        if self.fixed_seed:
            return prng.prng_key(42)
        self._rng, key = prng.split(self._rng)
        return key

    def poke_map(self, pokes, poke_size=5):
        """(H, W, 2) poke of ``pokes`` ({x, y, dx, dy} in display
        coordinates); zero for an empty list."""
        size = self.image.shape[0]
        scale = size / self.display_size
        if not pokes:
            return np.zeros((size, size, 2), np.float32)
        coords = np.array([[p["y"] * scale, p["x"] * scale] for p in pokes])
        disps = np.array([[p["dy"] * scale, p["dx"] * scale] for p in pokes])
        return poke_from_coords((size, size), coords, disps, poke_size=poke_size)

    @torch.no_grad()
    def sample(self, x0, poke, key, length):
        """(B, length, H, W, 3) videos of start frames ``x0`` (B, H, W, 3) and
        pokes (B, H, W, 2): z of ``reverse_input_shape`` drawn from ``key``,
        the flow's reverse (K2 on the card), the augment channels cut, the
        first stage's decode."""
        spec = self.spec
        cond = second_stage.embed_cond(self.params, spec, x0, poke)
        z = prng.normal(key, transformer.reverse_input_shape(
            spec.flow, x0.shape[0], spec.latent_size, spec.flow_in_channels), x0.device)
        motion = transformer.reverse(self.params["flow"], spec.flow, z.to(x0.dtype), cond)
        if spec.augment_channels:
            motion = motion[..., :-spec.augment_channels]
        return second_stage.decode_first_stage(self.params, spec, motion, x0, length)

    def generate(self, pokes, length=None, poke_size=5):
        """(video (length, H, W, 3) numpy f32, poke (H, W, 2)) for ``pokes``;
        ``length`` defaults to the first stage's ``max_frames - 1``."""
        poke = self.poke_map(pokes, poke_size)
        length = length or self.spec.first_stage.max_frames - 1
        key = self.next_key()
        x0 = torch.from_numpy(self.image[None]).to(self.device)
        vid = self.sample(x0, torch.from_numpy(poke[None]).to(self.device), key, int(length))
        return vid[0].float().cpu().numpy(), poke


def load_session(config_path, model_name, device=None):
    """(session, dirs, test split) of a run, loaded as ``test``
    loads it; the session's display size and ``fixed_seed`` from the
    config's ``ui`` section."""
    from ipoke_tpu_torch.config import load_parameters
    from ipoke_tpu_torch.data.datamodule import StaticDataModule
    from ipoke_tpu_torch.experiments.second_stage import DATAKEYS, load_for_serving

    config, dirs = load_parameters(config_path, model_name, test_mode="samples")
    params, spec = load_for_serving(config, dirs, device)
    ui = config.get("ui", {})
    session = InteractiveSession(params, spec, display_size=int(ui.get("display_size", 256)),
                                 fixed_seed=bool(ui.get("fixed_seed", False)))
    datamod = StaticDataModule(config["data"], datakeys=DATAKEYS)
    datamod.setup()
    return session, dirs, datamod.datasets["test"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.eval.interactive")
    ap.add_argument("-c", "--config", default="configs/second_stage.yaml")
    ap.add_argument("-m", "--model_name", required=True)
    ap.add_argument("--pokes", required=True, help='JSON list of {"x","y","dx","dy"}')
    ap.add_argument("--length", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--example", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    from ipoke_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None
    sess, dirs, test_ds = load_session(args.config, args.model_name, device)
    sess.set_image(test_ds[args.example]["images"][0])
    vid, _ = sess.generate(json.loads(args.pokes), length=args.length)
    out = args.out or os.path.join(dirs["generated"], "interactive",
                                   time.strftime("%Y-%m-%d_%H-%M-%S"))
    clip = np.concatenate([sess.image[None], vid], 0)
    save_video(clip, os.path.join(out, "generated.mp4"))
    save_image(enrollment(clip), os.path.join(out, "enrollment.png"))
    result = {"frames": int(vid.shape[0]), "out": out}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
