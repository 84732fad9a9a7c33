"""The port's data path (``ipoke_tpu_torch/data``) against the JAX package's
on the CPU: the same seeds and index sequences through both give bitwise
the same numpy arrays.

* samplers: every sampler's order over two epochs;
* pokes: ``simulate_poke`` (moving, zero-poke, with a foreground mask),
  both foreground masks, ``keypoint_poke`` and ``poke_from_coords``;
* augmentation: ``color_jitter`` and ``geometric`` on a shared rng;
* frames: the PNG decode equals PIL's pixels for every colour type and row
  filter; the LANCZOS resize is within 1 uint8 level of PIL's everywhere
  (no pixel differs on the sizes below);
* datasets: every subclass, with ``augment`` off and on, over every
  datakey branch, through ``StaticDataModule`` for two training epochs with
  zero pokes and the val split, on a tree stored at 24^2 and read at 16^2;
  GrabCut with cv2 and the flow-mask fallback without it;
* the trainers' training order: the batches the stage-2 trainer steps on
  over two epochs equal JAX's ``StaticDataModule.loader("train")``'s, on
  the synthetic dataset and on a disk tree;
* the loader: ``n_workers: 0`` yields the one-worker batches; a consumer
  that stops early stops the producer; ``device_prefetch`` on the CPU.
"""
import builtins
import io
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from ipoke_tpu.data import augment as jaug
from ipoke_tpu.data import datamodule as jdm
from ipoke_tpu.data import poke as jpoke
from ipoke_tpu.data import samplers as jsam
from ipoke_tpu_torch.data import augment, datamodule, image, loader, native, poke, samplers
from ipoke_tpu_torch.data.datasets import get_dataset
from ipoke_tpu_torch.data.tree import write_tree
from ipoke_tpu_torch.utils.video import save_image
from torch_port_util import CPU

ALL_KEYS = ("images", "poke", "flow", "sample_ids", "original_flow", "keypoints_rel",
            "keypoint_poke", "keypoints_abs", "app_img_random", "app_img_cmp", "img_aT", "img_sT",
            "app_img_dis", "nn")
DATASETS = ("PlantDataset", "VegetationDataset", "TaichiDataset", "IperDataset", "Human36mDataset")


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 videos of 10 frames stored at 24^2, lags of 3 and 6 frames,
    keypoints and nn pairs; 2 videos train."""
    root = tmp_path_factory.mktemp("tree")
    return write_tree(str(root), n_videos=3, n_frames=10, size=24, gaps=(3, 6), train_videos=2,
                      keypoints=True)


def _data_cfg(meta, name, **kw):
    cfg = {"dataset": name, "meta_path": meta, "spatial_size": [16, 16], "max_frames": 3,
           "batch_size": 2, "n_workers": 1, "zero_poke": True, "zero_poke_amount": 3,
           "augment": False, "seed": 3, "poke_size": 3, "n_pokes": 3}
    cfg.update(kw)
    return cfg


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.FixedLengthSampler(23, True, 4, seed=5),
    lambda m: m.FixedLengthSampler(23, False, seed=5),
    lambda m: m.SequenceSampler(23, [1, 2, 3], 4, shuffle=True, drop_last=False, seed=2),
    lambda m: m.SequenceLengthSampler(23, 6, 4, zero_poke=True, zeropoke_weight=2.0,
                                      longest_seq_weight=3.0, seed=1),
    lambda m: m.SequenceLengthSampler(10, 4, 3, shuffle=False, seed=1),
    lambda m: m.SequentialSampler(7),
    lambda m: m.WeightedRandomSampler(np.arange(1, 9), 12, seed=4),
], ids=["fixed_zero", "fixed", "sequence", "length_zero", "length_ordered", "sequential",
        "weighted"])
def test_samplers_match_jax(make):
    got, want = make(samplers), make(jsam)
    assert len(got) == len(want)
    for _ in range(2):       # a second epoch continues each sampler's rng
        assert list(got) == list(want)


# ---------------------------------------------------------------------------
# pokes and augmentation
# ---------------------------------------------------------------------------

def _flow(seed, size=32):
    rng = np.random.default_rng(seed)
    flow = np.zeros((size, size, 2), np.float32)
    flow[8:20, 10:24] = rng.normal(0, 3, 2)
    return flow + rng.normal(0, 0.1, flow.shape).astype(np.float32)


@pytest.mark.parametrize("zero,masked,fix", [(False, False, False), (True, False, False),
                                             (False, True, False), (True, True, True)])
def test_simulate_poke_matches_jax(zero, masked, fix):
    flow = _flow(1)
    cfg_j = jpoke.PokeConfig(poke_size=3, n_pokes=4, fix_n_pokes=fix, spatial_size=(32, 32))
    cfg_p = poke.PokeConfig(poke_size=3, n_pokes=4, fix_n_pokes=fix, spatial_size=(32, 32))
    mask = jpoke.flow_foreground_mask(flow, cfg_j) if masked else None
    if masked:
        assert np.array_equal(poke.flow_foreground_mask(flow, cfg_p), mask)
    want = jpoke.simulate_poke(flow, cfg_j, np.random.default_rng(7), zero_poke=zero,
                               foreground_mask=mask)
    got = poke.simulate_poke(flow, cfg_p, np.random.default_rng(7), zero_poke=zero,
                             foreground_mask=mask)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    with pytest.raises(poke.FlowError):
        poke.simulate_poke(np.zeros_like(flow), cfg_p, np.random.default_rng(0))


def test_grabcut_keypoint_and_coord_pokes_match_jax():
    pytest.importorskip("cv2")
    img = np.random.default_rng(2).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    cfg_j = jpoke.PokeConfig(poke_size=3, n_pokes=3, spatial_size=(32, 32))
    cfg_p = poke.PokeConfig(poke_size=3, n_pokes=3, spatial_size=(32, 32))
    assert np.array_equal(poke.grabcut_foreground_mask(img, cfg_p),
                          jpoke.grabcut_foreground_mask(img, cfg_j))
    kp0 = np.random.default_rng(3).uniform(0, 32, (8, 2)).astype(np.float32)
    kp1 = kp0 + np.random.default_rng(4).normal(0, 3, kp0.shape).astype(np.float32)
    for g, w in zip(poke.keypoint_poke(kp0, kp1, cfg_p, np.random.default_rng(5)),
                    jpoke.keypoint_poke(kp0, kp1, cfg_j, np.random.default_rng(5))):
        assert np.array_equal(g, w)
    coords, disp = np.asarray([[5, 7], [20, 11]]), np.asarray([[1.5, -2.0], [0.5, 3.0]])
    assert np.array_equal(poke.poke_from_coords((32, 32), coords, disp, 3),
                          jpoke.poke_from_coords((32, 32), coords, disp, 3))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    flows = [rng.normal(0, 2, (16, 16, 2)).astype(np.float32) for _ in range(2)]
    cfg_p, cfg_j = augment.AugmentConfig(), jaug.AugmentConfig()
    got = augment.color_jitter(frames, np.random.default_rng(seed), cfg_p)
    assert np.array_equal(got, jaug.color_jitter(frames, np.random.default_rng(seed), cfg_j))
    (gf, gl), (wf, wl) = (augment.geometric(frames, flows, np.random.default_rng(seed), cfg_p),
                          jaug.geometric(frames, flows, np.random.default_rng(seed), cfg_j))
    assert np.array_equal(gf, wf) and all(np.array_equal(a, b) for a, b in zip(gl, wl))


# ---------------------------------------------------------------------------
# PNG decode and LANCZOS
# ---------------------------------------------------------------------------

def _natural(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(yy / 5.0)[..., None] * 60 + np.cos(xx / 3.0)[..., None] * 50 + 128
            + rng.normal(0, 8, (h, w, 3)))
    return np.clip(base, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "RGBA", "P"])
def test_png_decode_equals_pil(mode):
    """PIL's own encoder (adaptive row filters) in every colour type."""
    img = Image.fromarray(_natural(0))
    im = img.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(image.decode_png(data), want)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 0, 3, 1, 2)])
def test_png_filters_round_trip_through_pil(tmp_path, filters):
    """The port's writer with each row filter: PIL reads the pixels back,
    and so do the port's one-image and batched decoders."""
    img = _natural(1)
    path = str(tmp_path / "f.png")
    save_image(img, path, filters=filters)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), img)
    assert np.array_equal(image.read_png(path), img)
    both = image.decode_pngs([open(path, "rb").read()] * 2)
    assert all(np.array_equal(b, img) for b in both)


def test_png_refuses_what_it_cannot_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="bit depth"):
        image.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        image.decode_png(b"GIF89a")


@pytest.mark.parametrize("shape,out", [((256, 256), (128, 128)), ((300, 200), (128, 128)),
                                       ((100, 90), (128, 128)), ((130, 257), (64, 96))])
def test_lanczos_within_one_level_of_pil(shape, out):
    """Within 1 uint8 level everywhere; the share of pixels off by one is
    0 on these sizes (the float64 coefficients and the exact integer sums
    reproduce PIL's fixed point)."""
    img = np.clip(np.random.default_rng(sum(shape)).normal(128, 60, shape + (3,)), 0,
                  255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out[1], out[0]), Image.LANCZOS), np.int32)
    got = image.resize_lanczos(img, out).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() == 0.0


# ---------------------------------------------------------------------------
# datasets and the data module
# ---------------------------------------------------------------------------

def _batches(dm, split, epochs=1):
    return [b for _ in range(epochs) for b in dm.loader(split)]


@pytest.mark.parametrize("augment_on", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("name", DATASETS)
def test_datasets_match_jax_on_every_datakey(tree, name, augment_on):
    """Two training epochs with zero pokes and the val split, every datakey
    branch, one loader thread: bitwise JAX's batches (its frames through PIL,
    the port's through ``data/image``)."""
    cfg = _data_cfg(tree, name, augment=augment_on)
    want = jdm.StaticDataModule(cfg, datakeys=ALL_KEYS)
    got = datamodule.StaticDataModule(cfg, datakeys=ALL_KEYS)
    for split, epochs in (("train", 2), ("val", 1)):
        w, g = _batches(want, split, epochs), _batches(got, split, epochs)
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            _equal(a, b)
    assert any((b["sample_ids"] == -1).any() for b in _batches(got, "train"))


def test_grabcut_falls_back_to_the_flow_mask_without_cv2(tree, monkeypatch):
    """iPER's foreground mask: with cv2 missing both packages take the flow
    mask in the same ``except``, and the batches stay JAX's."""
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *a, **k)

    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    cfg = _data_cfg(tree, "IperDataset")
    want = _batches(jdm.StaticDataModule(cfg), "train")
    got = _batches(datamodule.StaticDataModule(cfg), "train")
    for a, b in zip(got, want):
        _equal(a, b)
    ds = get_dataset("IperDataset")(tree, datamodule.dataset_config_from(cfg), train=True)
    flow = ds._load_flow(int(ds.ids[0]))
    assert np.array_equal(ds._foreground_mask(flow, ds._load_frames(int(ds.ids[0]))),
                          poke.flow_foreground_mask(flow, ds.cfg.poke))


@pytest.mark.parametrize("cxx,flags,says", [
    ("g++-that-does-not-exist", None, "No such file or directory"),
    ("g++", native.CXX_FLAGS + ("-fno-such-option",), "-fno-such-option"),
], ids=["no-compiler", "compiler-error"])
def test_native_loader_raises_the_compilers_message(tree, monkeypatch, tmp_path, cxx, flags,
                                                    says):
    """``IPOKE_NATIVE=1`` with an engine that does not build: the example
    raises the build's error with the compiler's message, never a
    ``FlowError`` retry or a quiet numpy load."""
    monkeypatch.setenv("IPOKE_NATIVE", "1")
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "CXX_FLAGS", flags or native.CXX_FLAGS)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    ds = get_dataset("PlantDataset")(tree, datamodule.dataset_config_from(_data_cfg(tree, "x")))
    with pytest.raises(native.NativeBuildError, match=says):
        ds[0]
    assert not list(tmp_path.iterdir())


def _synthetic_cfg(**kw):
    cfg = {"dataset": "SyntheticDataset", "spatial_size": [16, 16], "max_frames": 3,
           "batch_size": 2, "n_examples": 7, "seed": 3, "n_pokes": 2, "poke_size": 3,
           "zero_poke": True, "zero_poke_amount": 3, "n_workers": 1}
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_n_workers_zero_yields_the_one_worker_batches(workers):
    """JAX's loader hangs with ``n_workers: 0`` (its producer thread calls
    ``ThreadPoolExecutor(0)``, which raises); the port's loads in the
    producer thread and gives JAX's one-worker batches, as more workers do
    on the synthetic dataset (no shared rng there)."""
    want = _batches(jdm.StaticDataModule(_synthetic_cfg(n_workers=1)), "train", 2)
    got = _batches(datamodule.StaticDataModule(_synthetic_cfg(n_workers=workers)), "train", 2)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _equal(a, b)


def test_an_early_stop_stops_the_producer():
    dm = datamodule.StaticDataModule(_synthetic_cfg(n_examples=40, n_workers=2))
    before = threading.active_count()
    for i, _ in enumerate(dm.loader("train")):
        if i == 1:
            break
    assert threading.active_count() == before


def test_a_failing_example_raises_in_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"example {i}")

    with pytest.raises(KeyError, match="example"):
        list(loader.DataLoader(Broken(), samplers.SequentialSampler(4), 2, num_threads=0))


def test_device_prefetch_keeps_order_and_keys():
    batches = [{"a": np.full((2, 3), i, np.float32), "b": np.arange(2) + i} for i in range(5)]
    got = list(loader.device_prefetch(iter(batches), CPU, keys=("a",), size=2))
    assert len(got) == 5 and all(list(g) == ["a"] for g in got)
    assert all(torch.equal(g["a"], torch.from_numpy(b["a"])) for g, b in zip(got, batches))


# ---------------------------------------------------------------------------
# the trainers' training order
# ---------------------------------------------------------------------------

def _recorded_stage2_batches(monkeypatch, tmp_path, data_cfg, n_steps):
    """The batches ``experiments/second_stage.train`` steps on, its step
    replaced by a recorder."""
    from ipoke_tpu_torch.experiments import second_stage as experiment
    from ipoke_tpu_torch.train import second_stage as train_ss
    from torch_port_util import tiny_config

    seen = []

    def make_train_step(spec, frozen, opt, **kw):
        def step(state, batch, rng):
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
            return state._replace(step=state.step + 1), {"flow_loss": torch.zeros(())}
        return step

    monkeypatch.setattr(train_ss, "make_train_step", make_train_step)
    cfg = tiny_config(tmp_path)
    cfg["general"]["experiment"] = "second_stage"
    cfg["data"] = dict(data_cfg, spatial_size=[64, 64])
    cfg["training"] = {"n_epochs": 2, "max_batches_per_epoch": 100}
    dirs = {k: str(tmp_path / k) for k in ("ckpt", "generated")}
    monkeypatch.setattr(experiment, "validate", lambda *a, **k: {"FVD-val": 1.0})
    experiment.train(cfg, dirs, device="cpu", max_steps=n_steps)
    return seen, cfg["data"]


@pytest.mark.parametrize("disk", [False, True], ids=["synthetic", "disk"])
def test_trainer_batches_follow_jax_training_order(monkeypatch, tmp_path, disk):
    """The stage-2 trainer's batches over two epochs, zero pokes on: JAX's
    ``StaticDataModule.loader("train")`` batches, bitwise, epoch by epoch
    (one loader thread on the disk tree, whose examples share one rng)."""
    if disk:
        meta = write_tree(str(tmp_path / "tree"), n_videos=2, n_frames=8, size=64, gaps=(3,),
                          train_videos=1)
        data = _data_cfg(meta, "IperDataset", spatial_size=[64, 64])
    else:
        data = _synthetic_cfg(n_examples=5)
    seen, data = _recorded_stage2_batches(monkeypatch, tmp_path, data, n_steps=None)
    want = _batches(jdm.StaticDataModule(data), "train", 2)
    assert len(seen) == len(want) >= 4
    for g, w in zip(seen, want):
        _equal(g, {k: w[k] for k in g})
    assert any((w["sample_ids"] == -1).any() for w in want)
