"""The test modes accuracy, kps_acc, control_sensitivity and transfer, and
the stage-2 validation's latent scatter, against the JAX package's formulas
on the CPU, on tests/torch_port_util.py's tiny second stage (64x64, 3
frames; tests/test_torch_eval.py's ``model``).

A recording wrapper around ``forward_sample`` shows what each mode samples
(batches, sample counts, pokes, keys: JAX's ``split`` chains, bitwise); JAX's
own functions then recompute each payload value, CSV row and artefact from
the recorded videos: ``best_of_n_metric`` of ``metrics/image`` (over the
port's ``ssim_per_frame``, held to JAX's in tests/test_torch_metrics.py),
``kps_nn_protocol``, ``poke_from_coords``, ``make_multipoke_grid`` and
``enrollment``.  Two stand-ins keep each case under a second: LPIPS (held
to JAX's in tests/test_torch_metrics.py) by a mean absolute difference, and
the depth-50 pose net (held to JAX's in tests/test_torch_pose.py) by
keypoints read off the frames.  Whole modes and ``_log_latents`` against
JAX's own are ``slow``.
"""
import csv
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ipoke_tpu.data.poke import poke_from_coords as jpoke_from_coords
from ipoke_tpu.metrics import image as jimage
from ipoke_tpu.metrics import pose as jpose
from ipoke_tpu.utils import vis as jvis
from ipoke_tpu.utils.video import enrollment as jenrollment
from ipoke_tpu_torch.data.datamodule import StaticDataModule as PortDataModule
from ipoke_tpu_torch.eval import test_modes
from ipoke_tpu_torch.experiments import second_stage as experiment
from ipoke_tpu_torch.metrics import lpips as lpips_mod
from ipoke_tpu_torch.metrics import pose
from ipoke_tpu_torch.metrics.image import ssim_per_frame
from ipoke_tpu_torch.utils import prng
from test_torch_prng import NORMAL_TOL
from test_torch_eval import (SEED, ListData, _dirs, _jax_keys, _jax_model, _mode_config,  # noqa: F401
                             model, stand_in_features)
from torch_port_util import CPU

# the modes' numbers against the formulas recomputed in float32
REL_TOL = 2e-5
# flow samples and posterior means of the latent scatter against JAX's
FLOW_TOL = 2e-4
KPS_STATUS = ("pose weights unavailable (no-egress env): keypoint numbers come "
              "from a RANDOM backbone (protocol check only); provide "
              "$IPOKE_WEIGHTS/pose_resnet_152.npz for real keypoint metrics")


@pytest.fixture
def record(monkeypatch):
    """Every ``forward_sample`` call: its key, sample count, images, poke
    and videos."""
    calls = []
    real = test_modes.second_stage.forward_sample

    def wrapped(params, spec, batch, rng=None, n_samples=1, **kw):
        out = real(params, spec, batch, rng, n_samples=n_samples, **kw)
        calls.append({"key": rng, "n": n_samples, "images": batch["images"].numpy().copy(),
                      "poke": batch["poke"].numpy().copy(), "out": out.numpy().copy()})
        return out

    monkeypatch.setattr(test_modes.second_stage, "forward_sample", wrapped)
    return calls


def _kp_stand_in(frames):
    """Keypoints read off (N, H, W, 3) frames: 4 points of the first row's
    pixels in [0, 1]; the pose net's stand-in on both sides."""
    return np.asarray(frames)[:, 0, :8, 0].reshape(-1, 4, 2) * 0.5 + 0.5


@pytest.fixture
def stand_ins(monkeypatch):
    """LPIPS as the mean |a - b| per frame, the pose net as ``_kp_stand_in``."""
    monkeypatch.setattr(lpips_mod, "lpips", lambda a, b: (a - b).abs().mean(dim=(1, 2, 3)))
    monkeypatch.setattr(pose, "keypoints_rel", lambda images: (
        torch.from_numpy(_kp_stand_in(images.numpy())), None))


def _close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * (1 + np.abs(ref).max()), (got, ref)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _neg_ssim_frames(a, b):
    """Minus the SSIM of each frame: JAX's ``vmap`` of ``ssim``, to which
    the port's ``ssim_per_frame`` is held in tests/test_torch_metrics.py."""
    got = ssim_per_frame(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b)))
    return -jnp.asarray(got.numpy())


def _jax_accuracy(call, kp_gt=None):
    """JAX's run_accuracy numbers of one recorded call: best-of-N per-frame
    means of the LPIPS stand-in and of SSIM, and the KPS protocol's stats."""
    vids, tgt = jnp.asarray(call["out"]), jnp.asarray(call["images"][:, 1:])
    lp, _ = jimage.best_of_n_metric(lambda a, b: jnp.abs(a - b).mean(axis=(1, 2, 3)), vids, tgt)
    ss, _ = jimage.best_of_n_metric(_neg_ssim_frames, vids, tgt)
    b, t = tgt.shape[:2]
    if kp_gt is None:
        kp_gt = _kp_stand_in(call["images"][:, 1:].reshape((b * t,) + tgt.shape[2:])).reshape(b, 1, t, 4, 2)
    kp_pred = np.stack([_kp_stand_in(call["out"][si].reshape((b * t,) + tgt.shape[2:])).reshape(b, t, 4, 2)
                        for si in range(call["out"].shape[0])], axis=1)
    return np.asarray(lp), -np.asarray(ss), jpose.kps_nn_protocol(kp_pred, kp_gt)


@pytest.mark.parametrize("gt_kps", ["pose_net", "dataset"])
def test_run_accuracy_matches_jax_formulas(model, record, stand_ins, tmp_path, gt_kps):
    """2 samples of 3 examples: two batches of 2 on JAX's keys; the payload,
    the CSV and both plots as JAX's run_accuracy makes them; with the
    batch's static ``keypoints_rel`` the ground truth's keypoints are those,
    in every frame."""
    cfg, spec, params, batches = model
    if gt_kps == "dataset":
        rng = np.random.default_rng(9)
        batches = [dict(b, keypoints_rel=rng.uniform(0, 1, (2, 4, 2)).astype(np.float32))
                   for b in batches]
    dirs = _dirs(tmp_path)
    out = test_modes.run_accuracy(
        params, spec, _mode_config(cfg, n_samples_per_data_point=2, n_samples_metrics=3),
        ListData(batches), dirs)
    assert [c["key"] for c in record] == _jax_keys(SEED, 2) and [c["n"] for c in record] == [2, 2]
    refs = [_jax_accuracy(c, None if gt_kps == "pose_net" else
                          np.repeat(b["keypoints_rel"][:, None, None], 2, axis=2))
            for c, b in zip(record, batches)]
    lp = np.mean(np.stack([r[0] for r in refs]), 0)
    ss = np.mean(np.stack([r[1] for r in refs]), 0)
    nn = np.concatenate([r[2]["nn_err"] for r in refs])
    nn_pf = np.concatenate([r[2]["nn_err_per_frame"] for r in refs]).mean(0)
    assert set(out) == {"LPIPS_UNPRETRAINED_per_frame", "SSIM_per_frame", "LPIPS_UNPRETRAINED",
                        "SSIM", "n", "KPS_UNPRETRAINED", "KPS_UNPRETRAINED_per_frame"}
    assert out["n"] == 4
    _close(out["LPIPS_UNPRETRAINED_per_frame"], lp)
    _close(out["SSIM_per_frame"], ss)
    _close([out["LPIPS_UNPRETRAINED"], out["SSIM"]], [lp.mean(), ss.mean()])
    _close(out["KPS_UNPRETRAINED_per_frame"], nn_pf)
    _close(out["KPS_UNPRETRAINED"], nn.mean())
    mdir = tmp_path / "generated" / "metrics"
    rows = _csv(mdir / "accuracy.csv")
    assert rows[0] == ["frame", "LPIPS", "SSIM"] and len(rows) == 3
    assert [[int(r[0]), float(r[1]), float(r[2])] for r in rows[1:]] == [
        [i, a, b] for i, (a, b) in enumerate(zip(out["LPIPS_UNPRETRAINED_per_frame"], out["SSIM_per_frame"]))]
    for png in ("lpips_per_frame.png", "accuracy_two_axes.png"):
        assert Image.open(mdir / png).format == "PNG"
    with open(mdir / "accuracy.json") as f:
        assert json.load(f) == out


def test_run_accuracy_without_matplotlib_writes_the_csv_then_raises(model, stand_ins, tmp_path,
                                                                    monkeypatch):
    """As JAX's: the metrics computed and accuracy.csv written, then the
    first plot raises ModuleNotFoundError (the card's machine may lack
    matplotlib); no accuracy.json."""
    cfg, spec, params, batches = model
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        test_modes.run_accuracy(params, spec, _mode_config(cfg, n_samples_per_data_point=2,
                                                           n_samples_metrics=2),
                                ListData(batches), _dirs(tmp_path))
    mdir = tmp_path / "generated" / "metrics"
    rows = _csv(mdir / "accuracy.csv")
    assert len(rows) == 3 and all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    assert not (mdir / "accuracy.json").exists()


def test_run_accuracy_summarize_n_pokes(model, record, stand_ins, tmp_path):
    """testing.summarize_n_pokes: the mode once per poke count 1..n_pokes,
    each on ``StaticDataModule`` of the config's data with that fixed count
    (the first test batch of each), keyed by the count."""
    cfg, spec, params, _ = model
    config = _mode_config(dict(cfg, data=dict(cfg["data"], n_pokes=2)), n_samples_per_data_point=2,
                          n_samples_metrics=2, summarize_n_pokes=True)
    out = test_modes.run_accuracy(params, spec, config, None, _dirs(tmp_path))
    assert list(out) == [1, 2] and [c["key"] for c in record] == _jax_keys(SEED, 1) * 2
    for n, c in zip((1, 2), record):
        first = next(iter(PortDataModule(dict(config["data"], n_pokes=n, fix_n_pokes=True))
                          .loader("test")))
        assert np.array_equal(c["images"], first["images"]) and np.array_equal(c["poke"], first["poke"])
        lp, ss, _ = _jax_accuracy(c)
        assert set(out[n]) == {"LPIPS_UNPRETRAINED", "SSIM"}
        _close([out[n]["LPIPS_UNPRETRAINED"], out[n]["SSIM"]], [lp.mean(), ss.mean()])
    with open(tmp_path / "generated" / "metrics" / "accuracy_per_n_pokes.json") as f:
        assert json.load(f) == {str(k): v for k, v in out.items()}


@pytest.mark.parametrize("kp_poke", [False, True], ids=["batch_poke", "keypoint_poke"])
def test_run_kps_acc_matches_jax_formulas(model, record, stand_ins, tmp_path, kp_poke):
    """keypoint_mse: every test batch (3 <= 8) with 2 samples on the keys of
    prng_key(0), the poke replaced by ``keypoint_poke`` where the batch has
    one; then, without pose weights, JAX's status and the pixel proxy: 3
    examples (two batches) of one sample on the keys of testing.seed."""
    cfg, spec, params, batches = model
    if kp_poke:
        rng = np.random.default_rng(11)
        batches = [dict(b, keypoint_poke=rng.normal(0, 2, b["poke"].shape).astype(np.float32))
                   for b in batches]
    out = test_modes.run_kps_acc(
        params, spec, _mode_config(cfg, n_samples_per_data_point=2, n_samples_metrics=3),
        ListData(batches), _dirs(tmp_path))
    assert [c["key"] for c in record] == _jax_keys(0, 3) + _jax_keys(SEED, 2)
    assert [c["n"] for c in record] == [2, 2, 2, 1, 1]
    for c, b in zip(record, batches + batches[:2]):
        assert np.array_equal(c["images"], b["images"])
    for c, b in zip(record[:3], batches):
        assert np.array_equal(c["poke"], b["keypoint_poke" if kp_poke else "poke"])
    for c, b in zip(record[3:], batches):
        assert np.array_equal(c["poke"], b["poke"])
    stats = [_jax_accuracy(c)[2] for c in record[:3]]
    assert set(out) == {"KPS_mse_UNPRETRAINED", "KPS_mse_UNPRETRAINED_per_frame", "pose_pretrained",
                        "status", "pixel_epe_proxy_last_frame", "pixel_epe_proxy_all_frames",
                        "n_examples"}
    _close(out["KPS_mse_UNPRETRAINED"], np.concatenate([s["nn_err"] for s in stats]).mean())
    _close(out["KPS_mse_UNPRETRAINED_per_frame"],
           np.concatenate([s["nn_err_per_frame"] for s in stats]).mean(0))
    assert out["pose_pretrained"] is False and out["status"] == KPS_STATUS and out["n_examples"] == 4
    proxy = [(np.abs(c["out"][0][:, -1] - c["images"][:, -1]).mean(),
              np.abs(c["out"][0] - c["images"][:, 1:]).mean()) for c in record[3:]]
    _close([out["pixel_epe_proxy_last_frame"], out["pixel_epe_proxy_all_frames"]],
           np.mean(np.asarray(proxy, np.float64), 0))


def test_run_control_sensitivity_matches_jax_formulas(model, record, tmp_path):
    """2 directions over 3 examples (two batches of 2), 1 artefact example:
    the first batch samples its own poke, then each direction; the second
    the directions only; keys, pokes, responses, the CSV and every artefact
    as JAX's formulas give them."""
    cfg, spec, params, batches = model
    out = test_modes.run_control_sensitivity(
        params, spec, _mode_config(cfg, n_control_sensitivity_pokes=2, n_samples_metrics=3,
                                   n_samples_vis=1), ListData(batches), _dirs(tmp_path))
    assert [c["key"] for c in record] == _jax_keys(SEED, 5) and all(c["n"] == 1 for c in record)
    angle_rng = np.random.default_rng(0)
    per_dir, align, calls = [[], []], [], iter(record)
    for bi, batch in enumerate(batches[:2]):
        poke, imgs = batch["poke"], batch["images"]
        b, h, w, _ = poke.shape
        centers = np.stack(np.unravel_index(np.abs(poke).sum(-1).reshape(b, -1).argmax(1), (h, w)), -1)
        base_mag = np.linalg.norm(poke.reshape(b, -1, 2), axis=-1).max(1)
        region = np.zeros((b, h, w, 1), np.float32)
        for i, (r, c) in enumerate(centers):
            region[i, max(r - 8, 0):r + 8, max(c - 8, 0):c + 8] = 1.0
        vis_pokes, vis_vids, responses = [], [], []
        if bi == 0:
            c0 = next(calls)
            assert np.array_equal(c0["poke"], poke)
            vis_pokes.append(poke)
            vis_vids.append(c0["out"][0])
        for ki in range(2):
            theta = angle_rng.uniform(0, 2 * np.pi, b)
            disp = np.stack([np.sin(theta), np.cos(theta)], -1) * base_mag[:, None]
            pokes = np.stack([jpoke_from_coords((h, w), centers[i:i + 1], disp[i:i + 1]) for i in range(b)])
            c = next(calls)
            assert np.array_equal(c["poke"], pokes) and np.array_equal(c["images"], imgs)
            resp = np.abs(c["out"][0] - imgs[:, :1]).mean(-1, keepdims=True)
            per_dir[ki].append(float((resp.mean(1) * region).sum() / region.sum() / b))
            responses.append(resp.mean((1, 2, 3, 4)))
            if bi == 0:
                vis_pokes.append(pokes)
                vis_vids.append(c["out"][0])
        arr = np.stack(responses)
        align.append(float(arr.std(0).mean() / (arr.mean() + 1e-8)))
        if bi == 0:
            rows, grid, grid_unl = jvis.make_multipoke_grid(
                imgs[0, 0], np.stack([p[0] for p in vis_pokes]), imgs[0, 1:],
                np.stack([v[0] for v in vis_vids]))
    per_dir_mean = [float(np.mean(r)) for r in per_dir]
    assert set(out) == {"per_direction_response", "mean_response", "response_cv_across_directions",
                        "n_examples", "n_directions", "artifact_dir", "n_artifact_examples"}
    assert out["n_examples"] == 4 and out["n_directions"] == 2 and out["n_artifact_examples"] == 1
    _close(out["per_direction_response"], per_dir_mean)
    _close([out["mean_response"], out["response_cv_across_directions"]],
           [np.mean(per_dir_mean), np.mean(align)])
    rows_csv = _csv(tmp_path / "generated" / "metrics" / "control_sensitivity.csv")
    assert rows_csv == [["direction", "response"]] + [[str(i), str(v)] for i, v in
                                                      enumerate(out["per_direction_response"])]
    root = tmp_path / "generated" / "poke_dir_samples_best_fvd"
    assert out["artifact_dir"] == str(root)
    (sid,) = os.listdir(root)
    assert sid == f"sid_{int(batches[0]['sample_ids'][0])}"
    (stamp,) = os.listdir(root / sid)
    names = ["groundtruth", "sample_1", "sample_2", "sample_3"]
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(root / sid / stamp))
    assert stems == sorted(["overview", "samples_all"] + names + [f"{n}_enrollment" for n in names])
    for name, row in zip(names, rows):
        got = np.asarray(Image.open(root / sid / stamp / f"{name}_enrollment.png"))
        assert np.array_equal(got, jenrollment(row)), name
    videos = {os.path.splitext(f)[0]: f for f in os.listdir(root / sid / stamp)}
    if videos["overview"].endswith(".npy"):   # no cv2: the grids themselves
        assert np.array_equal(np.load(root / sid / stamp / videos["overview"]), grid)
        assert np.array_equal(np.load(root / sid / stamp / videos["samples_all"]), grid_unl)


@pytest.fixture
def transfers(monkeypatch):
    """Every ``transfer_batch`` call: its inputs and outputs."""
    calls = []
    real = test_modes.transfer_batch

    def wrapped(params, spec, batch, x_b, poke_b):
        out = real(params, spec, batch, x_b, poke_b)
        calls.append({"x": batch["images"].numpy(), "poke": batch["poke"].numpy(),
                      "x_b": x_b.numpy(), "poke_b": poke_b.numpy(),
                      "out": [o.numpy() for o in out]})
        return out

    monkeypatch.setattr(test_modes, "transfer_batch", wrapped)
    return calls


@pytest.mark.parametrize("partner", ["roll", "nn"])
def test_run_transfer_matches_jax_formulas(model, transfers, tmp_path, partner):
    """3 examples: two batches of 2; B is the batch rolled by one, or the
    dataset's ``nn_images``/``nn_poke``; the energies are JAX's per-frame
    means, the correlation their mean over batches; 3 of each video written."""
    cfg, spec, params, batches = model
    if partner == "nn":
        batches = [dict(b, nn_images=batches[2]["images"], nn_poke=batches[2]["poke"])
                   for b in batches]
    out = test_modes.run_transfer(params, spec, _mode_config(cfg, n_samples_metrics=3, n_samples_vis=3),
                                  ListData(batches), _dirs(tmp_path))
    assert len(transfers) == 2
    corr = []
    for c, b in zip(transfers, batches):
        assert np.array_equal(c["x"], b["images"]) and np.array_equal(c["poke"], b["poke"])
        want_b = ((batches[2]["images"], batches[2]["poke"]) if partner == "nn"
                  else (np.roll(b["images"], 1, axis=0), np.roll(b["poke"], 1, axis=0)))
        assert np.array_equal(c["x_b"], want_b[0]) and np.array_equal(c["poke_b"], want_b[1])
        vids, src_e, tr_e = c["out"]
        assert vids.shape == (2, 2, 64, 64, 3) and np.all(np.isfinite(vids))
        _close(src_e, np.asarray(jnp.mean(jnp.abs(c["x"][:, 1:] - c["x"][:, :1]), axis=(2, 3, 4))))
        _close(tr_e, np.asarray(jnp.mean(jnp.abs(vids - c["x_b"][:, :1]), axis=(2, 3, 4))))
        a, bb = src_e.reshape(-1), tr_e.reshape(-1)
        if a.std() > 1e-8 and bb.std() > 1e-8:
            corr.append(float(np.corrcoef(a, bb)[0, 1]))
    assert set(out) == {"n", "dir", "motion_energy_correlation"} and out["n"] == 4
    _close(out["motion_energy_correlation"], np.mean(corr))
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(out["dir"]))
    assert stems == sorted(f"{k}_{i}" for k in ("transfer", "source", "target") for i in range(3))


def test_transfer_batch_of_its_own_conditioning_returns_the_motion(model):
    """Under A's own conditioning the reverse undoes the forward: decoding
    the returned motion equals decoding A's posterior motion (within the
    flow's round trip)."""
    _, spec, params, batches = model
    batch = test_modes._to_batch(batches[0], CPU)
    x = batch["images"]
    vids, _, _ = test_modes.transfer_batch(params, spec, batch, x, batch["poke"])
    with torch.no_grad():
        motion, _ = experiment.second_stage.encode_first_stage(params, spec, x)
        ref = experiment.second_stage.decode_first_stage(params, spec, motion, x[:, 0], x.shape[1] - 1)
    _close(vids.numpy(), ref.numpy(), tol=FLOW_TOL)


# ---------------------------------------------------------------------------
# the latent scatter of the stage-2 validation
# ---------------------------------------------------------------------------

@pytest.fixture
def reverses(monkeypatch):
    """Every ``transformer.reverse`` of ``latent_samples``: z and its output."""
    calls = []
    real = experiment.transformer.reverse

    def wrapped(params, spec, z, cond):
        out = real(params, spec, z, cond)
        calls.append({"z": z.numpy().copy(), "out": out.numpy().copy()})
        return out

    monkeypatch.setattr(experiment.transformer, "reverse", wrapped)
    return calls


def test_validate_draws_the_latent_scatter_as_jax(model, reverses, tmp_path, stand_in_features):
    """After the FVD, the first 2 val batches again (max_val_batches 1 does
    not cut it): z of each drawn in the motion latent's shape on the keys of
    ``split`` from PRNGKey(5) (JAX's key chain bitwise, the normals within
    tests/test_torch_prng.py's 1e-6 of JAX's: XLA's and torch's f32
    ``log1p``/``sqrt`` in ``erf_inv`` differ by an ulp), through the flow's
    reverse; the PNG in the log directory."""
    cfg, spec, params, batches = model
    data = ListData(batches)
    out = experiment.validate(params, spec, dict(cfg, training={"max_val_batches": 1}), data,
                              log_dir=str(tmp_path / "log"))
    assert data.splits == ["val", "val"] and np.isfinite(out["FVD-val"])
    assert len(reverses) == 1 + 2         # the FVD's sample, then two scatter batches
    shape = (2, 8, 8, spec.flow_in_channels)
    for call, key in zip(reverses[1:], _jax_keys(5, 2)):
        assert call["z"].dtype == np.float32
        assert np.array_equal(call["z"], prng.normal(key, shape).numpy())
        want = np.asarray(jax.random.normal(jnp.asarray(key, jnp.uint32), shape))
        np.testing.assert_allclose(call["z"], want, rtol=0, atol=NORMAL_TOL)
    assert Image.open(tmp_path / "log" / "latents.png").format == "PNG"
    z_post, z_samp = experiment.latent_samples(params, spec, ListData(batches))
    assert z_post.shape == (4, 8 * 8 * spec.flow_in_channels) == z_samp.shape
    assert np.array_equal(z_samp, np.concatenate([c["out"].reshape(2, -1) for c in reverses[1:3]]))


def test_validate_without_matplotlib_skips_the_scatter(model, tmp_path, monkeypatch, caplog,
                                                       stand_in_features):
    """No matplotlib: the validation logs "latent scatter skipped" and still
    returns its metrics, as JAX's ``try`` does; without a log directory no
    scatter is drawn."""
    cfg, spec, params, batches = model
    config = dict(cfg, training={"max_val_batches": 1})
    ref = experiment.validate(params, spec, config, ListData(batches))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.WARNING, logger=experiment.log.name):
        got = experiment.validate(params, spec, config, ListData(batches), log_dir=str(tmp_path))
    assert got == ref and "latent scatter skipped" in caplog.text
    assert not (tmp_path / "latents.png").exists()


# ---------------------------------------------------------------------------
# slow: whole modes and the latent scatter against JAX's own
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_latent_samples_match_jax(model, tmp_path):
    """``_log_latents``'s posterior means and flow samples: the port's
    against JAX's ``encode_first_stage`` and ``transformer.reverse`` on the
    same batches and keys."""
    from ipoke_tpu.flows import transformer as jtransformer
    from ipoke_tpu.models import second_stage as jss

    cfg, spec, params, batches = model
    jspec, jparams = _jax_model(cfg, spec, params)
    z_post, z_samp = experiment.latent_samples(params, spec, ListData(batches))
    rng = jax.random.PRNGKey(5)
    for bi, b in enumerate(batches[:2]):
        x = jnp.asarray(b["images"])
        motion, mu = jss.encode_first_stage(jparams, jspec, x)
        cond = jss.embed_cond(jparams, jspec, x[:, 0], jnp.asarray(b["poke"]))
        rng, sub = jax.random.split(rng)
        z = jax.random.normal(sub, motion.shape[:-1] + (jspec.flow_in_channels,))
        out = jtransformer.reverse(jparams["flow"], jspec.flow, z, cond)
        _close(z_post[2 * bi:2 * bi + 2], np.asarray(mu).reshape(2, -1), FLOW_TOL)
        _close(z_samp[2 * bi:2 * bi + 2], np.asarray(out).reshape(2, -1), FLOW_TOL)


MODE_REL_TOL = {"per_direction_response": 2e-4, "mean_response": 2e-4,
                "response_cv_across_directions": 2e-3, "motion_energy_correlation": 2e-3,
                "LPIPS_UNPRETRAINED": 1e-4, "SSIM": 1e-3, "KPS_UNPRETRAINED": 1e-3,
                "KPS_mse_UNPRETRAINED": 1e-3, "pixel_epe_proxy_last_frame": 2e-4,
                "pixel_epe_proxy_all_frames": 2e-4}


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["control_sensitivity", "transfer", "kps_acc", "accuracy"])
def test_whole_mode_matches_jax(model, tmp_path, mode):
    """Each mode end to end against JAX's on the same params and data
    (JAX's real LPIPS and pose net, the port's oneDNN off): the same keys,
    the numbers within MODE_REL_TOL relative."""
    from ipoke_tpu.eval import test_modes as jmodes

    cfg, spec, params, batches = model
    jspec, jparams = _jax_model(cfg, spec, params)
    config = _mode_config(cfg, n_samples_per_data_point=2, n_samples_metrics=2, n_samples_vis=1,
                          n_control_sensitivity_pokes=2)
    ref = getattr(jmodes, f"run_{mode}")(jparams, jspec, config, ListData(batches),
                                         {"generated": str(tmp_path / "jax")})
    with torch.backends.mkldnn.flags(enabled=False):
        got = getattr(test_modes, f"run_{mode}")(params, spec, config, ListData(batches),
                                                 {"generated": str(tmp_path / "port")})
    assert set(got) == set(ref)
    print(mode, {k: (got[k], ref[k]) for k in ref if k in MODE_REL_TOL})
    for k, tol in MODE_REL_TOL.items():
        if k in ref:
            _close(got[k], ref[k], tol)
