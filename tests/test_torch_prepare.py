"""The port's data preparation (``ipoke_tpu_torch/data/{prepare,human36m}.py``)
against the JAX package's on the CPU:

* ``extract_frames`` of a tiny MJPG ``.avi``: the same PNG files, byte for
  byte (cv2 in both);
* ``compute_flows`` with Horn-Schunck and with PWC-lite on a
  ``pwc_lite.npz`` in a temporary ``$IPOKE_WEIGHTS`` (both packages'
  ``default_params`` cleared before and after): the same file names, flows
  within 1e-4 * (1 + max|ref|);
* ``build_meta``: the two pickles equal key for key, dtype for dtype, value
  for value (1, 3 and 11 videos: the single-video and ``int(n * 0.9)``
  rules); the legacy ``prediction_{lag}_{i}`` naming and an unparseable
  name raise ``RuntimeError`` in both;
* ``keypoint_nn_ids`` without pose weights (the image branch: PIL's
  ``convert("L").resize((16, 16))``, whose default filter for mode L is
  bicubic): ``nn_ids`` exactly equal, ties among identical frames included;
  ``data/image.to_grey`` and ``resize`` equal PIL's pixel for pixel;
* ``human36m``: ``extract_all`` of tgz archives made here gives the same
  files, and ``is_test_subject`` and the subject lists agree;
* the chain into training: a video extracted, its flows computed and its
  meta built by the port is read by the port's ``FlowVideoDataset`` and
  ``IperDataset`` as by JAX's, example for example, bitwise.
"""
import filecmp
import os
import pickle
import tarfile

import numpy as np
import pytest
import torch

from ipoke_tpu.data import datasets as jds
from ipoke_tpu.data import human36m as jh36m
from ipoke_tpu.data import prepare as jprep
from ipoke_tpu.data.poke import PokeConfig as JPokeConfig
from ipoke_tpu.ops import pwc as jpwc
from ipoke_tpu_torch.data import datasets, human36m, prepare
from ipoke_tpu_torch.data.poke import PokeConfig
from ipoke_tpu_torch.nn.core import resize_bilinear_align_corners
from ipoke_tpu_torch.ops import pwc
from ipoke_tpu_torch.utils import prng
from ipoke_tpu_torch.utils.video import save_image

cv2 = pytest.importorskip("cv2")

TOL = 1e-4


def _texture(rng, n, size, grid=6):
    """n smooth RGB frames in [-1, 1]: a moving crop of one smooth field."""
    coarse = torch.from_numpy(rng.standard_normal((1, grid, grid, 3)).astype(np.float32))
    big = np.tanh(resize_bilinear_align_corners(coarse, (size + 2 * n, size + 2 * n)).numpy()[0] * 1.5)
    return [big[i:i + size, 2 * i:2 * i + size] for i in range(n)]


def _write_video(path, frames):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(((f + 1) * 127.5).astype(np.uint8)[..., ::-1]))
    writer.release()


def _frame_dir(root, name, frames):
    paths = []
    for i, f in enumerate(frames):
        paths.append(save_image(f, os.path.join(root, name, f"frame_{i:06d}.png"), filters=range(5)))
    return paths


def test_extract_frames_writes_jax_pngs(tmp_path):
    video = tmp_path / "clip.avi"
    _write_video(video, _texture(np.random.default_rng(0), 6, 40))
    ref = jprep.extract_frames(str(video), str(tmp_path / "jax"), 24)
    out = prepare.extract_frames(str(video), str(tmp_path / "port"), 24)
    assert [os.path.basename(p) for p in ref] == [os.path.basename(p) for p in out] and len(out) == 6
    for a, b in zip(ref, out):
        assert filecmp.cmp(a, b, shallow=False)


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """A pwc_lite.npz of the port's init in a temporary $IPOKE_WEIGHTS, and
    both packages' cached params cleared around the test."""
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path / "weights"))
    pwc.save_params(pwc.init_pwc(prng.prng_key(21)))
    jpwc.default_params.cache_clear()
    pwc.default_params.cache_clear()
    yield
    jpwc.default_params.cache_clear()
    pwc.default_params.cache_clear()


@pytest.mark.parametrize("estimator", ["hs", "pwc"])
def test_compute_flows_matches_jax(tmp_path, weights, estimator):
    frames = _frame_dir(tmp_path, "v", _texture(np.random.default_rng(1), 5, 32))
    ref = jprep.compute_flows(frames, 2, str(tmp_path / "jax"), estimator=estimator)
    out = prepare.compute_flows(frames, 2, str(tmp_path / "port"), estimator=estimator, device="cpu")
    assert sorted(ref) == sorted(out) == [0, 1, 2]
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    for i in ref:
        a, b = np.load(ref[i]), np.load(out[i])
        assert b.shape == (32, 32, 2) and b.dtype == np.float32
        assert np.abs(a - b).max() <= TOL * (1 + np.abs(a).max())


def _fabricate(root, n_videos, n_frames=6, lag=2):
    rng = np.random.default_rng(n_videos)
    for v in rng.permutation(n_videos):
        vdir = os.path.join(root, f"vid{v:02d}")
        for i in range(n_frames):
            save_image(rng.uniform(-1, 1, (8, 8, 3)), os.path.join(vdir, f"frame_{i:06d}.png"))
            if i + lag < n_frames:
                np.save(os.path.join(vdir, f"prediction_{i}_{i + lag}.flow.npy"),
                        np.zeros((8, 8, 2), np.float32))
    open(os.path.join(root, "notes.txt"), "w").close()


@pytest.mark.parametrize("n_videos", [1, 3, 11])
def test_build_meta_matches_jax(tmp_path, n_videos):
    _fabricate(str(tmp_path), n_videos)
    with open(jprep.build_meta(str(tmp_path), str(tmp_path / "jax.p")), "rb") as f:
        ref = pickle.load(f)
    with open(prepare.build_meta(str(tmp_path)), "rb") as f:
        out = pickle.load(f)
    assert list(ref) == list(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype and ref[k].shape == out[k].shape, k
        np.testing.assert_array_equal(ref[k], out[k])
    assert out["train"].sum() == (4 if n_videos == 1 else int(n_videos * 0.9) * 4)


@pytest.mark.parametrize("names", [[f"prediction_5_{i}.flow.npy" for i in range(6)],
                                   ["prediction_1_3.flow.npy", "prediction_x.flow.npy"]])
def test_build_meta_refuses_legacy_and_unparseable_names(tmp_path, names):
    vdir = tmp_path / "vid0"
    vdir.mkdir()
    for n in names:
        np.save(vdir / n, np.zeros((8, 8, 2), np.float32))
    for build in (jprep.build_meta, prepare.build_meta):
        with pytest.raises(RuntimeError, match="legacy" if len(names) == 6 else "unparseable"):
            build(str(tmp_path))


@pytest.mark.parametrize("shape,size", [((37, 53), (16, 16)), ((128, 128), (16, 16)), ((15, 33), (9, 30)),
                                        ((20, 24), (64, 64))])
def test_grey_and_bicubic_resize_equal_pil(shape, size):
    """``data/image.to_grey`` and ``resize`` against PIL's ``convert("L")``
    and ``resize`` with its default filter (bicubic for modes L and RGB),
    pixel for pixel; LANCZOS too."""
    from PIL import Image

    from ipoke_tpu_torch.data import image

    rgb = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    grey = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(image.to_grey(rgb), grey)
    np.testing.assert_array_equal(image.resize(grey, size), np.asarray(Image.fromarray(grey).resize(size[::-1])))
    np.testing.assert_array_equal(image.resize(rgb, size), np.asarray(Image.fromarray(rgb).resize(size[::-1])))
    np.testing.assert_array_equal(image.resize(rgb, size, "lanczos"),
                                  np.asarray(Image.fromarray(rgb).resize(size[::-1], Image.LANCZOS)))


def test_keypoint_nn_ids_image_branch_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("IPOKE_WEIGHTS", str(tmp_path / "no_weights"))
    rng = np.random.default_rng(3)
    shared = rng.uniform(-1, 1, (20, 24, 3))
    for v in range(3):
        for i in range(4):
            img = shared if i == 0 else rng.uniform(-1, 1, (20, 24, 3))   # ties across videos
            save_image(img, str(tmp_path / f"v{v}" / f"frame_{i:06d}.png"), filters=range(5))
            np.save(tmp_path / f"v{v}" / f"prediction_{i}_{i + 1}.flow.npy", np.zeros((4, 4, 2), np.float32))
    meta = prepare.build_meta(str(tmp_path))
    with open(jprep.keypoint_nn_ids(meta, str(tmp_path / "jax_nn.p")), "rb") as f:
        ref = pickle.load(f)
    with open(prepare.keypoint_nn_ids(meta, device="cpu"), "rb") as f:
        out = pickle.load(f)
    assert list(ref) == list(out) and out["nn_ids"].dtype == np.int64
    np.testing.assert_array_equal(ref["nn_ids"], out["nn_ids"])
    assert (out["nn_ids"][[0, 4, 8]] == [4, 0, 0]).all()


def test_human36m_extract_all_and_subjects(tmp_path):
    for subject in ("S1", "S9"):
        src = tmp_path / "src" / subject
        (src / "Videos").mkdir(parents=True)
        (src / "Videos" / f"Walking.{subject}.mp4").write_bytes(subject.encode() * 10)
        for dest in ("jax", "port"):
            (tmp_path / dest).mkdir(exist_ok=True)
            with tarfile.open(tmp_path / dest / f"Videos_{subject}.tgz", "w:gz") as tf:
                tf.add(src / "Videos", arcname="Videos")
    jh36m.extract_all(str(tmp_path / "jax"))
    human36m.extract_all(str(tmp_path / "port"))
    for subject in ("S1", "S9"):
        cmp = filecmp.dircmp(tmp_path / "jax" / subject / "Videos", tmp_path / "port" / subject / "Videos")
        assert cmp.left_list == cmp.right_list == [f"Walking.{subject}.mp4"] and not cmp.diff_files
    assert human36m.SUBJECTS == jh36m.SUBJECTS and human36m.TEST_SUBJECTS == jh36m.TEST_SUBJECTS
    for p in ("data/S9/Videos/a.mp4", "data/S1/Videos", "x/S11", "x/S1", "S91/a"):
        assert human36m.is_test_subject(p) == jh36m.is_test_subject(p)


@pytest.mark.parametrize("name", ["FlowVideoDataset", "IperDataset"])
def test_prepared_tree_reads_as_in_jax(tmp_path, name):
    """A tree the port prepared (extracted PNGs, HS flows, meta.p) gives
    JAX's examples through the port's dataset."""
    rng = np.random.default_rng(4)
    (tmp_path / "videos").mkdir()
    for v in range(2):
        _write_video(tmp_path / "videos" / f"clip{v}.avi", _texture(rng, 9, 40))
        frames = prepare.extract_frames(str(tmp_path / "videos" / f"clip{v}.avi"),
                                        str(tmp_path / "tree" / f"clip{v}"), 32)
        prepare.compute_flows(frames, 3, str(tmp_path / "tree" / f"clip{v}"), estimator="hs",
                              device="cpu")
    meta = prepare.build_meta(str(tmp_path / "tree"))
    jcls = jds.FlowVideoDataset if name == "FlowVideoDataset" else jds.get_dataset(name)
    pcls = datasets.FlowVideoDataset if name == "FlowVideoDataset" else datasets.get_dataset(name)
    ref = jcls(meta, jds.DatasetConfig(spatial_size=32, max_frames=3,
                                      poke=JPokeConfig(poke_size=3, n_pokes=2)), train=True)
    out = pcls(meta, datasets.DatasetConfig(spatial_size=32, max_frames=3,
                                            poke=PokeConfig(poke_size=3, n_pokes=2)), train=True)
    assert len(out) == len(ref) > 0
    for idx in (0, len(ref) - 1, -1):
        a, b = ref[idx], out[idx]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)



@pytest.mark.slow
def test_smoke_motion_check_passes_jax_fit_and_fails_swapped_flows(tmp_path):
    """chip_smoke.py's check of the prep phase's flows against layered
    clips in known motion (``_prep_videos``, ``_motion_epe``), on JAX's own
    fit from ``default_params``' key (PRNGKey(1234)) through JAX's
    ``pwc_flow``, the frames extracted by the port: JAX's flows pass the
    phase's limits (EPE under PREP_EPE_RATIO of the displacement and under
    Horn-Schunck's), the same flows with (dy, dx) swapped fail them.  The
    readings are printed (run with -s)."""
    import jax

    import chip_smoke as cs
    from ipoke_tpu_torch.data.image import read_png

    motion = cs._prep_videos(str(tmp_path / "videos"), True)
    for name in motion:
        prepare.extract_frames(str(tmp_path / "videos" / f"{name}.avi"), str(tmp_path / "tree" / name),
                               cs.PREP_SIZE)

    def frames_of(name, ids):
        return torch.from_numpy(np.stack([
            np.asarray(read_png(str(tmp_path / "tree" / name / f"frame_{i:06d}.png")), np.float32) / 127.5 - 1
            for i in ids]))

    params = jpwc.train_synthetic(jax.random.PRNGKey(1234))
    flow = jax.jit(jpwc.pwc_flow)
    ids = range(0, cs.PREP_FRAMES - cs.PREP_LAG, cs.PREP_EVERY)
    flows = {name: {i: np.asarray(flow(params, frames_of(name, [i]).numpy(),
                                       frames_of(name, [i + cs.PREP_LAG]).numpy()))[0] for i in ids}
             for name in motion}
    swapped = {name: {i: f[..., ::-1] for i, f in fl.items()} for name, fl in flows.items()}
    got, bad = (cs._motion_epe(motion, f, frames_of, "cpu") for f in (flows, swapped))
    print(f"\nJAX's fit from 1234: {got}\nits flows with (dy, dx) swapped: {bad}")
    assert got["hs"] < got["zero"]
    assert got["pwc"] < cs.PREP_EPE_RATIO * got["zero"] and got["pwc"] < got["hs"]
    assert not (bad["pwc"] < cs.PREP_EPE_RATIO * bad["zero"] and bad["pwc"] < bad["hs"])
