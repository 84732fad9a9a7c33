"""The port's ``utils/vis``, ``utils/umap_lite``, ``utils/plots`` and
``utils/logging.latent_scatter`` against the JAX package's on the CPU: the
visualisations pixel for pixel (cv2 draws the arrows and labels where it is
installed, in both packages alike), the UMAP embedding bitwise, and the plots
written as PNGs."""
import os
import sys

import numpy as np
import pytest
from PIL import Image

from ipoke_tpu.utils import plots as jplots
from ipoke_tpu.utils import umap_lite as jumap
from ipoke_tpu.utils import vis as jvis
from ipoke_tpu_torch.utils import plots, umap_lite, vis
from ipoke_tpu_torch.utils.logging import latent_scatter

H = W = 32


def _inputs(seed=0, k=3, t=4, b=2, n=2):
    """Seeded frames in [-1, 1] (with values past the ends, which to_uint8
    clips), flows, and pokes of one 5x5 patch each (one left empty)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.1, 1.1, (b, H, W, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (b, t, H, W, 3)).astype(np.float32)
    samples = rng.uniform(-1, 1, (n, b, t, H, W, 3)).astype(np.float32)
    flow = rng.normal(0, 3, (b, H, W, 2)).astype(np.float32)
    pokes = np.zeros((k, H, W, 2), np.float32)
    for i in range(k - 1):
        r, c = rng.integers(4, H - 4, 2)
        pokes[i, r - 2:r + 3, c - 2:c + 3] = rng.normal(0, 6, 2)
    vids = rng.uniform(-1, 1, (k, t, H, W, 3)).astype(np.float32)
    return {"x0": x0, "gt": gt, "samples": samples, "flow": flow, "pokes": pokes, "vids": vids}


CASES = {
    "flow_to_color": lambda m, d: m.flow_to_color(d["flow"][0]),
    "flow_to_color_max_mag": lambda m, d: m.flow_to_color(d["flow"][1], max_mag=2.5),
    "draw_poke_arrows": lambda m, d: m.draw_poke_arrows(d["x0"][0], d["pokes"][0]),
    "draw_poke_arrows_empty": lambda m, d: m.draw_poke_arrows(d["x0"][1], d["pokes"][-1]),
    "make_sample_grid": lambda m, d: m.make_sample_grid(
        d["x0"], d["samples"], d["gt"], d["flow"], d["pokes"][:2]),
    "make_sample_grid_cols": lambda m, d: m.make_sample_grid(
        d["x0"], d["samples"], d["gt"], d["flow"], d["pokes"][:2], max_cols=1),
    "label_row": lambda m, d: m._label_row(m.temporal_border(d["gt"][0]), "Sample #2"),
    "grid_divisors": lambda m, d: np.asarray([m._grid_divisors(n) for n in range(1, 13)]),
    "make_multipoke_grid": lambda m, d: m.make_multipoke_grid(
        d["x0"][0], d["pokes"], d["gt"][0], d["vids"]),
    "make_multipoke_grid_padded": lambda m, d: m.make_multipoke_grid(
        d["x0"][1], d["pokes"][:2], d["gt"][1], d["vids"][:2], n_padded=2),
    "temporal_border": lambda m, d: m.temporal_border(d["gt"][1], width=3),
}


def _select_per_pixel(select):
    """``np.select`` with each condition given a trailing axis where it has
    one fewer than the choices: JAX's ``flow_to_color`` passes (H, W) sector
    masks with (H, W, 3) choices, which numpy refuses to broadcast, so its
    formula runs here only with the masks taken per pixel, as the port
    takes them."""
    def sel(conds, choices, default=0):
        nd = np.ndim(choices[0])
        return select([c[..., None] if np.ndim(c) == nd - 1 else c for c in conds], choices, default)
    return sel


@pytest.mark.parametrize("cv2", [True, False], ids=["cv2", "no_cv2"])
@pytest.mark.parametrize("case", list(CASES))
def test_vis_matches_jax_pixel_for_pixel(case, cv2, monkeypatch):
    """Without cv2 (the card's machine) both draw pokes as markers and no labels."""
    if not cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    d = _inputs()
    got = CASES[case](vis, d)
    monkeypatch.setattr(np, "select", _select_per_pixel(np.select))
    ref = CASES[case](jvis, d)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r), case


def test_umap_lite_matches_jax_bitwise():
    """60 points in three seeded blobs: the graph, the spectral start and
    every SGD epoch (the negative samples from the same seeded generator)
    give JAX's embedding bit for bit; so does the degenerate path."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal((20, 8)) + 6 * np.eye(8)[i] for i in range(3)])
    got = umap_lite.UMAPLite(n_epochs=60, seed=2).fit_transform(x)
    ref = jumap.UMAPLite(n_epochs=60, seed=2).fit_transform(x)
    assert got.shape == (60, 2) and np.all(np.isfinite(got))
    assert np.array_equal(got, ref)
    tiny = rng.standard_normal((5, 7))
    assert np.array_equal(umap_lite.UMAPLite().fit_transform(tiny),
                          jumap.UMAPLite().fit_transform(tiny))


def _png_ok(path):
    assert os.path.exists(path) and os.path.getsize(path) > 0
    with Image.open(path) as im:
        assert im.format == "PNG" and im.size[0] > 0


@pytest.mark.parametrize("kind", ["errorbar", "two_axes", "violin", "latent_scatter"])
def test_plots_write_pngs(tmp_path, kind):
    """Each plot writes a PNG where JAX's writes one, into a directory it makes."""
    rng = np.random.default_rng(1)
    mean, std = rng.uniform(0, 1, 6), rng.uniform(0, 0.1, 6)
    calls = {
        "errorbar": lambda m, p: m.errorbar_plot(p, mean, std, ylabel="LPIPS", title="t"),
        "two_axes": lambda m, p: m.two_axes_plot(p, np.arange(6), mean, std),
        "violin": lambda m, p: m.violin_plot(p, {"a": mean, "b": std}),
        "latent_scatter": lambda m, p: latent_scatter(
            p, {"posterior_mean": rng.standard_normal((12, 5)),
                "flow_samples": rng.standard_normal((12, 5))}),
    }
    path = str(tmp_path / "sub" / f"{kind}.png")
    assert calls[kind](plots, path) == path
    _png_ok(path)
    if kind != "latent_scatter":
        _png_ok(calls[kind](jplots, str(tmp_path / "jax" / f"{kind}.png")))
